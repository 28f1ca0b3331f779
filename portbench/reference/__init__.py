"""Plain PyTorch references of each configuration family, in float32
with TF32 off. They import nothing of `ray_tpu_torch`, `ray_tpu` or
`jax`, and take only what the benchmark made: the weights and the
inputs."""
