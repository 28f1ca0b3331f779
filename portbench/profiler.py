"""Device traces of the timed path, read from `torch.profiler`.

A copy of `chip_smoke.profile_steps`, `_kernel_class` and `_whole`, with
two repairs:

- the end markers. `profile_steps` recorded through a profiler
  `schedule` (a warm-up step, then the active one) and lost a marker kernel
  at one end of short windows now and then, so that its device figures
  came out short. Here the traced stretch runs inside one plain profiling
  session that opens after a throw-away session has brought the CUDA
  activity tracer up, with a marker kernel and a pause at each end, and a
  synchronize before the session closes. A trace that still lacks either
  marker is taken again, and after three cut traces the run fails: no
  figure is ever read from a trace that is incomplete at either end.
- kernels are grouped by the CUDA graph replay that launched them (the
  trace's correlation id of each `cudaGraphLaunch`), so that a reader can
  time one replay.

The trace is exported to a temporary file (under `$TMPDIR`), parsed and
deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np

MARKER_KERNEL = "spin_kernel"     # `torch.cuda._sleep`
PAD_S = 0.05
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# the port's attention kernels as the profiler names them (the functions
# of csrc/flash_attention_{fwd,bwd}.cu: route sm90 and route f32)
FLASH_FWD_KERNELS = ("fwd_sm90<", "fwd_f32<")
FLASH_BWD_KERNELS = ("dq_sm90<", "dkv_sm90<", "bwd_dq_f32<", "bwd_dkv_f32<")
# kernel-name fragments -> the kind of work, first match wins
KERNEL_CLASSES = (
    ("flash attention", FLASH_FWD_KERNELS + FLASH_BWD_KERNELS),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "gemv")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel", "softmax")),
    ("index/scatter", ("index", "gather", "scatter")),
    ("copy/cast", ("copy", "Cat", "Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    return next((cls for cls, keys in KERNEL_CLASSES
                 if any(key in name for key in keys)), "other")


class TraceCut(RuntimeError):
    """A trace lacked a marker at one end, every time it was taken."""


def _marker():
    import torch

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _session(body, quiet):
    """One profiling session around `body()`; returns the parsed trace
    events. The profiler starts and stops inside `quiet()`, during which
    no other thread may launch CUDA work."""
    from torch.profiler import ProfilerActivity, profile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        with quiet():
            prof.start()
            time.sleep(PAD_S)
            _marker()
        try:
            body()
        finally:
            with quiet():
                _marker()
                time.sleep(PAD_S)
                prof.stop()
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def record(body, quiet=contextlib.nullcontext) -> "Trace":
    """Trace `body()`, which runs the timed path and synchronizes;
    `quiet()` keeps other threads off the card while the profiler starts
    and stops."""
    _session(lambda: None, quiet)  # brings the tracer up; discarded
    for _ in range(ATTEMPTS):
        trace = Trace(_session(body, quiet))
        if trace.complete:
            return trace
    raise TraceCut(f"{ATTEMPTS} traces of the stretch were each incomplete "
                   f"(the last: {trace.markers} of 2 end markers)")


class Trace:
    """The device side of one traced stretch, between its two markers."""

    def __init__(self, events: list):
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        marks = sorted((e for e in dev if MARKER_KERNEL in e["name"]),
                       key=lambda e: e["ts"])
        self.markers = len(marks)
        self.complete = False
        if self.markers != 2:
            return
        lo = marks[0]["ts"] + marks[0]["dur"]
        hi = marks[1]["ts"]
        self.window_us = hi - lo
        self.ops = sorted((e for e in dev if MARKER_KERNEL not in e["name"]
                           and lo <= e["ts"] and e["ts"] + e["dur"] <= hi),
                          key=lambda e: e["ts"])
        self.busy_us = self._busy()
        # a stretch of the timed path launches work: a trace without any
        # is as incomplete as one without a marker
        self.complete = bool(self.ops)
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in HOST_CATS and lo <= e["ts"] <= hi]
        launches = [e for e in host if e.get("cat") == "cuda_runtime"
                    and "Launch" in e["name"]]
        self.launch_tid = Counter(e["tid"] for e in launches) \
            .most_common(1)[0][0] if launches else None
        self.host = [e for e in host if e["tid"] == self.launch_tid]
        graph_corr = {e["args"].get("correlation") for e in launches
                      if e["name"] == "cudaGraphLaunch"}
        groups = defaultdict(list)
        for e in self.ops:
            c = e.get("args", {}).get("correlation")
            if c in graph_corr:
                groups[c].append(e)
        # one list of kernels per graph replay, in launch order
        self.replays = [groups[c] for c in sorted(
            groups, key=lambda c: groups[c][0]["ts"])]
        self.lo, self.hi = lo, hi

    def _busy(self) -> float:
        busy, end = 0.0, -np.inf
        for e in self.ops:
            s, f = e["ts"], e["ts"] + e["dur"]
            if f <= end:
                continue
            busy += f - max(s, end)
            end = f
        return busy

    # -- readings (seconds) ---------------------------------------------

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def seconds_where(self, pred) -> float:
        return sum(e["dur"] for e in self.ops if pred(e["name"])) / 1e6

    def class_seconds(self) -> dict:
        out = defaultdict(float)
        for e in self.ops:
            out[kernel_class(e["name"])] += e["dur"] / 1e6
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for e in self.ops:
            by[e["name"][:160]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> list:
        """(start, length) of each idle interval of the device inside the
        window, in microseconds."""
        out, end = [], self.lo
        for e in self.ops:
            if e["ts"] > end:
                out.append((end, e["ts"] - end))
            end = max(end, e["ts"] + e["dur"])
        if self.hi > end:
            out.append((end, self.hi - end))
        return out

    def idle_gaps(self, n: int = 10, longest: int = 500) -> list:
        """The idle time of the `longest` gaps, summed by what the
        launching thread was doing at each gap's middle (its innermost
        host event then), the `n` largest sums."""
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:longest]
        if not gaps:
            return []
        starts = np.array([e["ts"] for e in self.host] or [0.0])
        ends = np.array([e["ts"] + e["dur"] for e in self.host] or [0.0])
        durs = ends - starts
        by = defaultdict(float)
        for s, length in gaps:
            mid = s + length / 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "host: no traced op (Python)" if hit.size == 0 else \
                self.host[int(hit[np.argmin(durs[hit])])]["name"][:160]
            by[name] += length / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def is_flash_fwd(name: str) -> bool:
    return any(k in name for k in FLASH_FWD_KERNELS)


def is_flash_bwd(name: str) -> bool:
    return any(k in name for k in FLASH_BWD_KERNELS)
