"""ray_tpu_torch._private — internals of the port: the deadman watchdog
(`health`) for its hot loops."""
