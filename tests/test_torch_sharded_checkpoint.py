"""Sharded array checkpoints of the port (DTensor leaves) against the JAX
package, after tests/test_sharded_checkpoint.py.

* A 4-rank gloo gang (dp=2, tp=2; `_torch_parallel_ranks.py`, gang
  "ckpt") saves a bf16 8x4 leaf sharded (dp, tp), a replicated DTensor
  leaf, a plain tensor, an int and a numpy array, each rank its own
  blocks (a replicated block only from the rank at coordinate 0). The
  JAX `restore_sharded` reads it bit for bit onto the 8-device CPU mesh
  at 4x2 and 2x4 and onto the host (unsharded).
* The reverse: a JAX `save_sharded` of an array sharded over the 4x2
  mesh, restored by the gang onto fsdp=4 and onto (dp=2, tp=2) DTensors,
  bit for bit, each rank holding its block.
* `test_structure_mismatch_rejected` and `test_incomplete_checkpoint_
  detected`, ported with DTensor leaves on a one-rank mesh.
* The elastic restore: a 2-rank gloo `TorchTrainer` gang holds `w`
  sharded over fsdp=2, rank 1 dies after the step-2 checkpoint, the
  retry restores each rank's half from the sharded checkpoint and the
  result is bit-identical; the checkpoint's rank-1 directory holds
  rank 1's shard.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu.train import array_checkpoint as jac  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig  # noqa: E402,E501
from ray_tpu_torch.train import array_checkpoint as tac  # noqa: E402


def _jax_state():
    st = ranks.ckpt_state()
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("dp", "tp"))
    return {"w": jax.device_put(jnp.asarray(st["w"], jnp.bfloat16),
                                NamedSharding(mesh, JP("dp", "tp"))),
            "b": jax.device_put(jnp.asarray(st["b"]),
                                NamedSharding(mesh, JP(None))),
            "step": st["step"], "rng": st["rng"]}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang's checkpoint (under the gang's dir) and its restores of
    the JAX package's checkpoint."""
    jdir = str(tmp_path_factory.mktemp("jaxck") / "ck")
    jac.save_sharded(jdir, _jax_state())
    return ranks.run_gang("ckpt", 4, tmp_path_factory.mktemp("ckpt"),
                          {"jax_ckpt": jdir})


def test_gang_writes_each_block_once(gang):
    """Rank 0 (coordinate (0, 0)) writes its block of w, the replicated
    b and the plain tensor; the others only their blocks of w."""
    got = gang["sc_ckpt_save"]["shards"]
    assert got["['w']"] == [[[0, 4], [0, 2]]]
    assert got["['b']"] == [[[0, 4]]]
    assert got["['plain']"] == [[[0, 6]]]
    ck = gang["sc_ckpt_save"]["dir"]
    blocks = {}
    for r in (1, 2, 3):
        with open(os.path.join(f"{ck}_shards", f"rank_{r}",
                               f"asv_index.{r}.json")) as f:
            for leaf in json.load(f)["leaves"]:
                if leaf["kind"] == "array":
                    blocks.setdefault(leaf["path"], []).extend(
                        sh["index"] for sh in leaf["shards"])
    assert sorted(blocks["['w']"]) == [[[0, 4], [2, 4]], [[4, 8], [0, 2]],
                                       [[4, 8], [2, 4]]]
    assert blocks["['b']"] == blocks["['plain']"] == []
    assert tac.is_usable(ck) and jac.is_usable(ck)


@pytest.mark.parametrize("target", ["4x2", "2x4", "host"])
def test_gang_checkpoint_restores_in_jax(gang, target):
    ck = gang["sc_ckpt_save"]["dir"]
    st = ranks.ckpt_state()
    devs = np.array(jax.devices())
    if target == "host":
        wl, bl = np.zeros((8, 4), jnp.bfloat16), np.zeros(4, np.float32)
    else:
        shape, spec = ((4, 2), JP("dp", "tp")) if target == "4x2" else \
            ((2, 4), JP("tp", "dp"))
        mesh = Mesh(devs.reshape(shape), ("dp", "tp"))
        wl = jax.ShapeDtypeStruct((8, 4), jnp.bfloat16,
                                  sharding=NamedSharding(mesh, spec))
        bl = jax.ShapeDtypeStruct((4,), jnp.float32,
                                  sharding=NamedSharding(mesh, JP("dp")))
    out = jac.restore_sharded(ck, {"w": wl, "b": bl,
                                   "plain": np.zeros(6, np.int32),
                                   "step": 0, "rng": np.zeros(3, np.int64)})
    w = np.asarray(out["w"])
    assert w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(w.astype(np.float32), st["w"])
    np.testing.assert_array_equal(np.asarray(out["b"]), st["b"])
    np.testing.assert_array_equal(out["plain"], np.arange(6))
    assert out["step"] == 7
    np.testing.assert_array_equal(out["rng"], np.arange(3))


@pytest.mark.parametrize("mesh", ["fsdp4", "dp2tp2"])
def test_jax_checkpoint_restores_in_the_gang(gang, mesh):
    got = gang["sc_ckpt_restore"][mesh]
    st = ranks.ckpt_state()
    assert got["w_dtype"] == "torch.bfloat16"
    np.testing.assert_array_equal(got["w"], st["w"])
    np.testing.assert_array_equal(got["b"], st["b"])
    assert got["step"] == 7
    np.testing.assert_array_equal(got["rng"], np.arange(3))
    # rank 0's block: rows 0-1 over fsdp=4; rows 0-3, columns 0-1 at
    # (dp=2, tp=2)
    want = st["w"][:2] if mesh == "fsdp4" else st["w"][:4, :2]
    np.testing.assert_array_equal(got["w_local"], want)


@pytest.fixture()
def one_rank(tmp_path):
    """A one-rank gloo group and a {"dp": 1} mesh."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield build_mesh({"dp": 1}, device="cpu")
    finally:
        dist.destroy_process_group()


def _dtensor(x, mesh):
    from ray_tpu_torch.parallel.sharding import P, as_global

    return as_global(x, mesh, P(*([None] * x.ndim)), shape=x.shape)


def test_structure_mismatch_rejected(one_rank, tmp_path):
    d = str(tmp_path / "ck")
    tac.save_sharded(d, {"a": _dtensor(torch.ones(4), one_rank), "b": 1})
    with pytest.raises(ValueError, match="structure mismatch"):
        tac.restore_sharded(d, {"a": _dtensor(torch.ones(4), one_rank)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tac.restore_sharded(d, {"a": _dtensor(torch.ones(5), one_rank),
                                "b": 0})


def test_incomplete_checkpoint_detected(one_rank, tmp_path):
    d = str(tmp_path / "ck")
    tac.save_sharded(d, {"a": _dtensor(torch.ones(4), one_rank)})
    ipath = os.path.join(
        d, [f for f in os.listdir(d) if f.startswith("asv_index")][0])
    with open(ipath) as f:
        rec = json.load(f)
    assert rec["leaves"][0]["shards"][0]["index"] == [[0, 4]]
    rec["num_processes"] = 2  # pretend a second writer never finished
    with open(ipath, "w") as f:
        json.dump(rec, f)
    assert not tac.is_usable(d)
    assert not jac.is_usable(d)


# -- elastic: a killed rank, a walk-back, a bit-identical resume ---------------


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


def _make_elastic_loop():
    # a factory, so that cloudpickle sends the loop by value: the train
    # workers cannot import this test module
    def loop(config):
        import os as os_mod

        import torch as torch_
        import torch.distributed as dist

        from ray_tpu_torch import train as t
        from ray_tpu_torch.parallel import build_mesh
        from ray_tpu_torch.parallel.sharding import P, as_global, local_block
        from ray_tpu_torch.train import array_checkpoint as ac

        mesh = build_mesh({"fsdp": 2}, device="cpu")
        w0 = torch_.arange(32, dtype=torch_.float32).reshape(8, 4)
        state = {"w": as_global(local_block(w0, mesh, P("fsdp")).clone(),
                                mesh, P("fsdp"), shape=w0.shape),
                 "step": torch_.zeros((), dtype=torch_.int32)}
        start = 0
        ckpt = t.get_checkpoint()
        if ckpt is not None and ac.is_sharded_checkpoint(ckpt):
            state = ac.restore_sharded(ckpt, state)
            start = int(state["step"])
        rank = dist.get_rank()
        for i in range(start, 4):
            if i == 2 and rank == 1 and start == 0:
                # hardware loss, first attempt only: the step-2 report (i ==
                # 1) returned here only after the gang committed it
                t.report({"step": i, "pre_crash": True})
                os_mod._exit(1)
            # elementwise on each rank's shard: no collective
            state = {"w": state["w"] * 2.0 + 1.0, "step": state["step"] + 1}
            # a local fingerprint (a dead peer cannot wedge the survivor)
            fp = float(state["w"].to_local().double().sum())
            t.report({"step": i + 1, "fp": fp, "resumed_from": start,
                      "rank": rank,
                      "local": tuple(state["w"].to_local().shape)},
                     checkpoint=ac.save_to_checkpoint(state))

    return loop


def test_elastic_restore_bit_identical(cluster, tmp_path):
    result = train.TorchTrainer(
        _make_elastic_loop(),
        backend_config=train.TorchConfig(distributed="on", platform="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            storage_path=str(tmp_path / "results"), name="elastic",
            failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.metrics["step"] == 4
    assert result.metrics["resumed_from"] == 2
    assert tuple(result.metrics["local"]) == (4, 4)
    w = np.arange(32, dtype=np.float64).reshape(8, 4)
    for _ in range(4):
        w = w * 2.0 + 1.0
    # rank 0's half: rows 0-3
    assert result.metrics["fp"] == float(w[:4].sum())
    ck = result.checkpoint.path
    assert tac.is_usable(ck) and jac.is_usable(ck)
    with open(os.path.join(f"{ck}_shards", "rank_1",
                           "asv_index.1.json")) as f:
        index = json.load(f)
    w_leaf = next(leaf for leaf in index["leaves"] if leaf["path"] == "['w']")
    assert w_leaf["shards"][0]["index"] == [[4, 8], [0, 4]]
    # the JAX package reads the gang's sharded checkpoint whole
    got = jac.restore_sharded(ck, {"step": np.zeros((), np.int32),
                                   "w": np.zeros((8, 4), np.float32)})
    np.testing.assert_array_equal(got["w"], w.astype(np.float32))
