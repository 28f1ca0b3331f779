"""ray_tpu_torch.parallel — meshes, sharding rules, collectives, ring and
Ulysses attention, the pipeline and expert parallelism over
`torch.distributed` (NCCL on the card, gloo on the CPU), and the
compiled-step cache (one CUDA graph per abstract signature and mesh,
`compile_cache`; `fold_steps` folds K steps into one).

Port of `ray_tpu/parallel/`: a `jax.sharding.Mesh` is a `Mesh` over a
`DeviceMesh` of ranks, a `NamedSharding` DTensor placements, and a
`shard_map` body a function of this rank's local shards whose
collectives run over the mesh's process groups."""

from ray_tpu_torch.parallel.compile_cache import (  # noqa: F401
    CacheStats, ExecutableCache, RetraceError, cache_stats, compiled_step,
    fold_steps, global_cache, stack_batches)
from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshConfig, build_hybrid_mesh, build_mesh, mesh_shape_for)
from ray_tpu_torch.parallel.ring_attention import (  # noqa: F401
    NEG_INF, expand_kv_heads, full_attention)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingStrategy, logical_axis_rules, shard_batch, sharding_constraint)

__all__ = ["CacheStats", "ExecutableCache", "Mesh", "MeshConfig", "NEG_INF",
           "RetraceError", "ShardingStrategy", "build_hybrid_mesh",
           "build_mesh", "cache_stats", "compiled_step", "expand_kv_heads",
           "fold_steps", "full_attention", "global_cache",
           "logical_axis_rules", "mesh_shape_for", "shard_batch",
           "sharding_constraint", "stack_batches"]
