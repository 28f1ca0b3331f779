"""ray_tpu_torch.train.array_checkpoint held to the JAX package's.

The port writes and reads the JAX package's on-disk format: a tree
saved by the JAX `save_sharded` (f32, bf16 and scalar leaves and a host
leaf, and an array sharded over the 8-device CPU mesh that
tests/conftest.py sets up) restores bit-identically in the port, a tree
saved by the port restores bit-identically in the JAX package, and both
write the same index for the same tree. Then the scenarios of
tests/test_sharded_checkpoint.py that need no cluster: a structure,
shape or dtype mismatch is rejected, and a checkpoint whose second
writer never finished is not usable.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ray_tpu.train import array_checkpoint as jac  # noqa: E402
from ray_tpu_torch.air import Checkpoint  # noqa: E402
from ray_tpu_torch.train import array_checkpoint as tac  # noqa: E402


def _values(seed=0):
    """numpy values of a carry-like tree: f32 and bf16 (as f32 values
    that bf16 holds exactly) matrices, an f32 scalar and an int vector."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "h": (rng.integers(-64, 64, (6, 2)) / 8).astype(np.float32),
            "s": np.float32(rng.standard_normal()),
            "i": rng.integers(0, 100, 5).astype(np.int32)}


def _jax_tree(v):
    return {"params": {"w": jnp.asarray(v["w"]),
                       "h": jnp.asarray(v["h"], jnp.bfloat16)},
            "opt": [jnp.asarray(v["s"]), (jnp.asarray(v["i"]),)],
            "epoch": 7, "skip": None}


def _torch_tree(v):
    return {"params": {"w": torch.from_numpy(v["w"]),
                       "h": torch.from_numpy(v["h"]).to(torch.bfloat16)},
            "opt": [torch.tensor(v["s"]), (torch.from_numpy(v["i"]),)],
            "epoch": 7, "skip": None}


def _bits(x):
    """The raw bytes of a jax array or torch tensor, as uint8."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _assert_same(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, int):
            assert a == b
            continue
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == \
            str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _index(d):
    name = [f for f in os.listdir(d) if f.startswith("asv_index")][0]
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def test_jax_checkpoint_restores_bit_identically_in_the_port(tmp_path):
    v = _values()
    d = str(tmp_path / "jax")
    jac.save_sharded(d, _jax_tree(v))
    assert tac.is_sharded_checkpoint(d) and tac.is_usable(d)
    like = _torch_tree(_values(seed=1))  # other values, same structure
    like["epoch"] = 0
    out = tac.restore_sharded(d, like)
    assert out["epoch"] == 7 and out["skip"] is None
    assert isinstance(out["opt"], list) and isinstance(out["opt"][1], tuple)
    _assert_same(out, _torch_tree(v))
    assert out["params"]["h"].dtype == torch.bfloat16


def test_port_checkpoint_restores_bit_identically_in_jax(tmp_path):
    v = _values(seed=2)
    d = str(tmp_path / "port")
    tac.save_sharded(d, _torch_tree(v))
    assert jac.is_sharded_checkpoint(d) and jac.is_usable(d)
    out = jac.restore_sharded(d, _jax_tree(_values(seed=3)))
    _assert_same(out, _jax_tree(v))
    assert out["epoch"] == 7


def test_both_write_the_same_index(tmp_path):
    v = _values(seed=4)
    jac.save_sharded(str(tmp_path / "jax"), _jax_tree(v))
    tac.save_sharded(str(tmp_path / "port"), _torch_tree(v))
    want, got = _index(tmp_path / "jax"), _index(tmp_path / "port")
    assert got == want
    assert [leaf["path"] for leaf in got["leaves"]] == [
        "['epoch']", "['opt'][0]", "['opt'][1][0]", "['params']['h']",
        "['params']['w']"]


def test_multi_shard_jax_checkpoint_is_assembled(tmp_path):
    """An array the JAX package saved as 8 shards of a 4x2 mesh (one
    process) is assembled from its shards in the port."""
    devs = jax.devices()
    assert len(devs) == 8
    mesh = Mesh(np.array(devs).reshape(4, 2), ("dp", "tp"))
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    state = {"w": jax.device_put(jnp.asarray(w, jnp.bfloat16),
                                 NamedSharding(mesh, P("dp", "tp"))),
             "b": jax.device_put(jnp.full((4,), 2.5, jnp.float32),
                                 NamedSharding(mesh, P(None)))}
    d = str(tmp_path / "ck")
    jac.save_sharded(d, state)
    assert len(_index(d)["leaves"][1]["shards"]) == 8  # "w"
    out = tac.restore_sharded(d, {"w": torch.zeros(8, 8,
                                                   dtype=torch.bfloat16),
                                  "b": torch.zeros(4)})
    assert torch.equal(out["w"].float(), torch.from_numpy(w))
    assert torch.equal(out["b"], torch.full((4,), 2.5))


def test_restore_returns_new_tensors_to_copy_into_a_live_carry(tmp_path):
    """Restore gives new tensors; copying them into the live carry keeps
    the carry's storages (what a graphed runner's replays read)."""
    carry = {"w": torch.ones(3), "step": torch.zeros(())}
    d = str(tmp_path / "ck")
    tac.save_sharded(d, carry)
    ptrs = {n: t.data_ptr() for n, t in carry.items()}
    carry["w"].mul_(5)
    carry["step"].add_(9)
    restored = tac.restore_sharded(d, carry)
    assert restored["w"].data_ptr() != ptrs["w"]
    for n, t in carry.items():
        t.copy_(restored[n])
        assert t.data_ptr() == ptrs[n]
    assert carry["w"].tolist() == [1.0] * 3 and float(carry["step"]) == 0


def test_save_to_checkpoint_stages_a_temp_checkpoint(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32), "n": 3}
    ckpt = tac.save_to_checkpoint(tree, base_dir=str(tmp_path))
    assert isinstance(ckpt, Checkpoint) and ckpt._temp_source
    assert os.path.dirname(ckpt.path) == str(tmp_path)
    out = tac.restore_sharded(ckpt, {"a": torch.zeros(4), "n": 0})
    assert out["a"].tolist() == [0.0, 1.0, 2.0, 3.0] and out["n"] == 3


def test_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    tac.save_sharded(d, {"a": torch.ones(4), "b": 1})
    with pytest.raises(ValueError, match="structure mismatch"):
        tac.restore_sharded(d, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tac.restore_sharded(d, {"a": torch.ones(5), "b": 0})
    with pytest.raises(ValueError, match="dtype mismatch"):
        tac.restore_sharded(d, {"a": torch.ones(4, dtype=torch.bfloat16),
                                "b": 0})
    with pytest.raises(ValueError, match="structure mismatch at leaf"):
        tac.restore_sharded(d, {"b": torch.ones(4), "c": 0})
    with pytest.raises(FileNotFoundError):
        tac.restore_sharded(str(tmp_path / "none"), {})


def test_incomplete_checkpoint_detected(tmp_path):
    d = str(tmp_path / "ck")
    tac.save_sharded(d, {"a": torch.ones(4)})
    ipath = os.path.join(
        d, [f for f in os.listdir(d) if f.startswith("asv_index")][0])
    with open(ipath) as f:
        rec = json.load(f)
    rec["num_processes"] = 2  # pretend a second writer never finished
    with open(ipath, "w") as f:
        json.dump(rec, f)
    assert not tac.is_usable(d)
    assert not jac.is_usable(d)
    assert tac.is_usable(str(tmp_path / "no-index"))  # nothing to doubt
