"""ray_tpu_torch._private — internals of the port: its own copy of the
JAX package's runtime (GCS, raylet, core worker, shared-memory object
store, scheduling, serialization, lockdep) and the deadman watchdog
(`health`)."""
