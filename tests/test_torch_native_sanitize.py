"""Sanitizer gates for the port's native store and dispatch ring, held
to `tests/test_native_sanitize.py`.

Builds `ray_tpu_torch/native/stress_test.cc` against the port's own
`shm_store.cc` and `request_ring.cc` with g++ under AddressSanitizer and
ThreadSanitizer, into the port's build directory
(`ray_tpu_torch/native/build/`), and runs it: the three phases must each
print the OK line that the JAX harness prints (single-shard store,
8-way-sharded store, request ring, the ring at the slot size the port
gives a GPT-2 deployment). A toolchain without the sanitizer skips, as
the JAX test does.
"""

import os
import subprocess

import pytest

_NATIVE = os.path.join(os.path.dirname(__file__), "..", "ray_tpu_torch",
                       "native")
_SOURCES = ("shm_store.cc", "request_ring.cc", "stress_test.cc")


def _build_and_stress(sanitizer: str, label: str,
                      extra_env: dict = None) -> None:
    out = os.path.join("build", f"stress_{sanitizer}")
    os.makedirs(os.path.join(_NATIVE, "build"), exist_ok=True)
    build = subprocess.run(
        [os.environ.get("CXX", "g++"), "-O1", "-g", "-std=c++17",
         f"-fsanitize={sanitizer}", "-fno-omit-frame-pointer", "-o", out,
         *_SOURCES, "-lpthread", "-lrt"],
        cwd=_NATIVE, capture_output=True, text=True, timeout=300)
    if build.returncode != 0 and "unrecognized" in (build.stderr or ""):
        pytest.skip(f"toolchain lacks {label} support")
    assert build.returncode == 0, build.stderr[-2000:]
    env = dict(os.environ)
    env.update(extra_env or {})
    # segments of this run only: another run (the other sanitizer, a
    # second checkout) may hold its own at the same time
    prefix = f"ray_tpu_torch_stress_{os.getpid()}_{sanitizer}"
    run = subprocess.run(
        [os.path.join(_NATIVE, out), "/" + prefix],
        capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, \
        f"{label} stress failed:\n{run.stdout[-1000:]}\n{run.stderr[-3000:]}"
    assert "stress OK (single-shard)" in run.stdout
    assert "stress OK (sharded)" in run.stdout
    assert "stress OK (request-ring)" in run.stdout
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


def test_shm_store_stress_under_asan():
    _build_and_stress("address", "ASAN")


def test_shm_store_stress_under_tsan():
    # halt_on_error so the first race fails the gate; second_deadlock_stack
    # reports both stacks of a lock inversion
    _build_and_stress(
        "thread", "TSAN",
        {"TSAN_OPTIONS": "halt_on_error=1 second_deadlock_stack=1"})
