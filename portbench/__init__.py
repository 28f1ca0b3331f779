"""The benchmark of `ray_tpu_torch` on an NVIDIA H100 (see `run.py`).

Nothing here imports `jax` or the JAX package `ray_tpu`; the system under
test is the PyTorch/CUDA port, `ray_tpu_torch`.
"""
