"""The port's host-level collectives and process-group bootstrap on its own
runtime: the three `HostGroup` scenarios of `tests/test_collectives_host.py`
(barrier / broadcast / allreduce / allgather / reducescatter / send-recv
over the rendezvous actor, two groups side by side, a dead rank timing
out), and `initialize_torch_distributed`'s rendezvous through the GCS KV
forming a gloo group of two actors and of one.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_host_group_collectives(cluster):
    @ray_tpu_torch.remote
    class Member:
        def __init__(self, rank: int, world: int):
            from ray_tpu_torch.parallel.collectives import HostGroup

            self.rank = rank
            self.world = world
            self.group = HostGroup("test-hg", world, rank)

        def run(self):
            g = self.group
            out = {}
            g.barrier()
            # broadcast: everyone sees root 0's value
            out["bcast"] = g.broadcast(
                value=("payload", self.rank) if self.rank == 0 else None,
                root=0)
            # allreduce: sum of ranks
            out["sum"] = g.allreduce_sum(np.full(4, float(self.rank)))
            # allgather: rank-ordered values
            out["gather"] = g.allgather(self.rank * 10)
            # reducescatter: each rank keeps its shard of the sum
            out["rs"] = g.reducescatter_sum(
                np.arange(6, dtype=np.float64) + self.rank)
            # ring send/recv: pass rank to the right neighbor
            g.send(self.rank, dst=(self.rank + 1) % self.world)
            out["recv"] = g.recv(src=(self.rank - 1) % self.world)
            # tag reuse across rounds must not collide
            g.barrier()
            out["sum2"] = g.allreduce_sum(1)
            return out

    world = 3
    members = [Member.remote(r, world) for r in range(world)]
    results = ray_tpu_torch.get([m.run.remote() for m in members],
                                timeout=120)

    for r, res in enumerate(results):
        assert res["bcast"] == ("payload", 0)
        np.testing.assert_allclose(res["sum"], np.full(4, 3.0))  # 0+1+2
        assert res["gather"] == [0, 10, 20]
        # reduce-scatter of sum_r (arange(6)+r): total = 3*arange(6)+3
        total = 3 * np.arange(6, dtype=np.float64) + 3
        np.testing.assert_allclose(
            res["rs"], np.array_split(total, world)[r])
        assert res["recv"] == (r - 1) % world
        assert res["sum2"] == world
    # the detached rendezvous actor must be cleaned up
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("collective:test-hg"))


def test_host_groups_concurrent_no_crosstalk(cluster):
    """Two groups with different names run interleaved collectives in
    parallel; tags/rounds never leak across groups."""
    @ray_tpu_torch.remote
    class Member:
        def __init__(self, group, rank, world, base):
            from ray_tpu_torch.parallel.collectives import HostGroup

            self.g = HostGroup(group, world, rank)
            self.base = base
            self.rank = rank

        def run(self):
            out = []
            for i in range(3):
                out.append(self.g.allreduce_sum(self.base + i))
                self.g.barrier()
            return out

    world = 2
    a = [Member.remote("grp-a", r, world, 100) for r in range(world)]
    b = [Member.remote("grp-b", r, world, 1000) for r in range(world)]
    results = ray_tpu_torch.get([m.run.remote() for m in a + b], timeout=120)
    for res in results[:world]:
        assert res == [200 + 2 * i for i in range(3)]
    for res in results[world:]:
        assert res == [2000 + 2 * i for i in range(3)]
    for name in ("grp-a", "grp-b"):
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(f"collective:{name}"))


def test_host_group_rank_failure_times_out(cluster):
    """A collective with a dead/absent rank fails with a timeout after the
    group's timeout_s instead of hanging forever."""
    import time as time_mod

    @ray_tpu_torch.remote
    class Flaky:
        def __init__(self, rank, world):
            from ray_tpu_torch.parallel.collectives import HostGroup

            self.g = HostGroup("grp-fail", world, rank, timeout_s=3.0)
            self.rank = rank

        def run(self):
            if self.rank == 1:
                import os
                os._exit(1)  # dies before joining the barrier
            t0 = time_mod.monotonic()
            try:
                self.g.barrier()
                return ("ok", time_mod.monotonic() - t0)
            except Exception as e:
                return (type(e).__name__, time_mod.monotonic() - t0)

    world = 2
    members = [Flaky.remote(r, world) for r in range(world)]
    ref0 = members[0].run.remote()
    members[1].run.remote()  # rank 1 kills itself
    kind, elapsed = ray_tpu_torch.get(ref0, timeout=60)
    assert kind == "GetTimeoutError"
    assert 2.0 < elapsed < 30.0  # bounded by timeout_s, not 300s
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("collective:grp-fail"))


@pytest.mark.parametrize("world", [2, 1])
def test_initialize_torch_distributed_rendezvous(cluster, world):
    """Rank 0 publishes host:port in the GCS KV, the others read it, every
    rank forms the gloo group (one rank too) and an all-reduce runs."""
    @ray_tpu_torch.remote
    class Rank:
        def join(self, group, world, rank):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch.parallel.distributed import (
                TorchDistributedConfig, initialize_torch_distributed)

            backend = initialize_torch_distributed(TorchDistributedConfig(
                group, world, rank, backend="gloo"))
            x = torch.tensor([float(rank + 1)])
            dist.all_reduce(x)
            out = (backend, dist.get_world_size(), dist.get_rank(), x.item())
            dist.destroy_process_group()
            return out

    actors = [Rank.remote() for _ in range(world)]
    got = ray_tpu_torch.get([a.join.remote(f"rdv-{world}", world, r)
                             for r, a in enumerate(actors)], timeout=120)
    total = float(sum(range(1, world + 1)))
    assert got == [("gloo", world, r, total) for r in range(world)]
    for a in actors:
        ray_tpu_torch.kill(a)
