#!/usr/bin/env python3
"""Round trips and put rate of one runtime package on this host.

    python tools/runtime_rtt.py ray_tpu_torch   # the port's runtime
    python tools/runtime_rtt.py ray_tpu         # the JAX package's runtime

Both runtimes are JAX-free, so both run on a host without JAX. The
script starts a node (2 CPUs, a 1 GiB store, no accelerator resource)
and prints one JSON line: the median round trip of a no-op task and of
an actor method over 200 calls each (after 20 warm calls), the put
GB/s of a 64 MiB numpy array (puts for 3 s after a warm one, as
`bench.py`'s object-plane phase measures it) beside a single-thread
host memcpy of the same bytes, and the first put of 512 MiB into the
fresh store (its pages written for the first time). Run both packages
on one host, in turns, to compare them.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

# the checkout's packages, whatever the working directory
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RTT_CALLS = 200
WARM_CALLS = 20


def _median_ms(call, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _rate_gbps(fn, nbytes, seconds):
    fn()  # warm
    n, start = 0, time.perf_counter()
    while time.perf_counter() - start < seconds:
        fn()
        n += 1
    return n * nbytes / (time.perf_counter() - start) / 1e9


def main(package: str) -> dict:
    rt = importlib.import_module(package)
    accel = {"num_gpus": 0} if package == "ray_tpu_torch" else {"num_tpus": 0}
    out = {"package": package}
    t0 = time.perf_counter()
    rt.init(num_cpus=2, object_store_memory=1 << 30, **accel)
    out["init_s"] = time.perf_counter() - t0
    try:
        big = np.ones(512 << 20, np.uint8)
        t0 = time.perf_counter()
        ref = rt.put(big)
        out["first_put_512mib_gbps"] = big.nbytes / (
            time.perf_counter() - t0) / 1e9
        del ref, big

        @rt.remote
        def noop():
            return None

        @rt.remote
        class Echo:
            def ping(self):
                return None

        echo = Echo.remote()
        for _ in range(WARM_CALLS):
            rt.get(noop.remote(), timeout=120)
            rt.get(echo.ping.remote(), timeout=120)
        out["task_rtt_ms"] = _median_ms(
            lambda: rt.get(noop.remote(), timeout=60), RTT_CALLS)
        out["actor_rtt_ms"] = _median_ms(
            lambda: rt.get(echo.ping.remote(), timeout=60), RTT_CALLS)

        arr = np.ones(64 << 20, np.uint8)
        dst = np.empty_like(arr)
        out["host_memcpy_gbps"] = _rate_gbps(lambda: np.copyto(dst, arr),
                                             arr.nbytes, 1.5)
        out["put_64mib_gbps"] = _rate_gbps(lambda: rt.put(arr), arr.nbytes,
                                           3.0)
    finally:
        rt.shutdown()
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("ray_tpu", "ray_tpu_torch"):
        sys.exit("usage: runtime_rtt.py ray_tpu|ray_tpu_torch")
    print(json.dumps(main(sys.argv[1])))
