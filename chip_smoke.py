#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (`nvcc`) and this checkout; no
network, no JAX. Phases, each of which raises (and so ends the run with
a non-zero exit) on any failed check:

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: every CUDA kernel source of the port, compiled from the
   checkout (`ray_tpu_torch/ops/csrc/*.cu` with the shared
   `csrc/hopper.cuh`, one nvcc each, in parallel), with each kernel
   instance's registers, stack and spill bytes parsed from ptxas' log
   (`ops/build/<name>.log`) and its dynamic shared memory and blocks per
   SM from the CUDA runtime;
3. kernels: `flash_attention_fwd` against its plain PyTorch version on
   the card at the serving shapes (GPT-2 prefill, Llama GQA, non-causal,
   the long-T regime, f32/fp16, head_dim 16/32/128) and the training
   paths' shapes (GPT-2 B=16 T=1024, Llama GQA 12:4 B=16 T=1024, B=4
   T=4096), with the kernel's time, the plain version's, a PyTorch library
   call's (a yardstick only), the least time the card could take, and the
   route that ran (`sm90`: wgmma + TMA ring, bf16/fp16; `f32`: CUDA
   cores);
4. backward kernels: `flash_attention_bwd` (dQ and dK/dV) against its
   plain version at the training shapes (GPT-2 B=16 T=1024, Llama GQA
   12:4, long context B=4 T=4096, non-causal, ragged T, fp16 d=128, f32
   d=16/32), with the same four times (the library's is SDPA forward +
   backward minus SDPA forward);
5. training: GPT-2 125M at full width and depth (bf16 compute, f32
   master weights, remat off), B=16, T=1024, flash attention, fused
   cross-entropy on the tied head, AdamW(3e-4, weight decay 1e-4) on one
   fixed random batch: a warm step, then 10 timed steps. Checks: finite,
   falling losses, both kernels launched n_layer times per step (the
   backward twice: dQ, dK/dV), and at B=4 the loss and every parameter
   gradient against a plain-attention (`full_attention`) model on the
   same weights. Prints tokens/s, MFU, peak memory and a profiled step.
   Then the same model, weights and batch through
   `ray_tpu_torch.train.TrainStepRunner`, the step (forward, fused-CE
   backward, AdamW(capturable=True) over a carry of the parameters and
   the optimizer state) captured as one CUDA graph (K=1: 10 timed
   replays) and four steps as one graph (K=4: 3 timed replays of 4).
   Checks: the losses follow the eager loop's (K=1) and K=1's (K=4)
   within TRAJ_RTOL; the miss takes exactly K optimizer steps; one cache
   miss, then only hits, no retrace; the kernels credited n_layer times
   per step (forward) and twice that (backward), and a profiled replay
   lists them (K=1 and K=4); one step record per run. In `train`, the K=1
   carry is saved with `array_checkpoint` after step 5, five steps run,
   the checkpoint is copied back into the live carry (every leaf equal
   to the saved one, bit for bit) and the same five steps run again:
   the losses repeat within TRAJ_RTOL. Prints step ms,
   tokens/s, MFU, the miss's seconds (eager steps + capture), the graph
   pool's memory, peak memory and a profiled replay's device-busy share.
   Then the same for Llama-125M at B=16, T=1024 (`train_llama`: GQA 12:4
   through both kernels, RoPE, SwiGLU, vocab 32000) and for GPT-2 125M
   at B=4, T=4096 (`train_long`: the T > 2048 regime of the Pallas
   kernels; its full_attention comparison runs at B=1);
6. serving: GPT-2 125M through `LLMEngine` at full width (random
   weights from a seed, bf16), every bucket a CUDA graph captured at
   `warmup()` (its seconds, graph count and memory printed): requests
   of 5-900 prompt tokens, two of them sharing a 64-token prefix, 32 new
   tokens each. Checks: every request finishes with the right length;
   no cache miss after `warmup()`, no retrace, and one cache hit per
   compiled step call; the flash kernel ran n_layer times per prefill
   (replays credited with their capture's launches; a profiled prefill
   replay shows n_layer forward kernels) and the backward never; no KV
   page leaked; each request's first-token logits agree with a
   plain-attention prefill; every captured bucket agrees with its eager
   step function on the same inputs and arena; the tokens equal those
   of the same engine calling its step functions eagerly (near-tie rule
   below); one request-recorder record per request with its phases
   tiling the total within 5 %, the registry's `serve_llm_*` and
   `compile_cache_*` lines with the run's counts, one step-profiler
   record per engine step, a pump probe that beat and never stalled;
   and after `shutdown()` the graphs and their memory are released.
   Prints decode ms/step at batch 8, prefill ms per bucket, profiles
   and tok/s with graphs and eager. Then the same, shorter, for
   Llama-125M (grouped-query attention);
7. speculative decoding (`engine_spec`): the GPT-2 engine phase's
   weights and prompts through the engine with K=4, once with a
   self-draft and once with an independent 2-layer draft, every target,
   verify and draft bucket a graph. Checks: the tokens equal the plain
   engine's (a token may differ only where the plain run's top-2 logit
   gap is a near tie within LOGIT_ATOL; that request's comparison stops
   there, and the stops are counted), no cache miss after `warmup()`,
   every bucket against its eager step function, the flash kernel ran
   for every target and draft prefill, no page leaked in either arena.
   Prints acceptance, rounds and tokens/s against plain;
8. the `kernels` JSON line (every ported kernel with its numbers), the
   card line, and last the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import shutil
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (BWD_KERNELS_PER_CALL,
                                               HEAD_DIMS, flash_attention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_plain,
                                               kernel_occupancy,
                                               kernel_routes)
from ray_tpu_torch.ops.fused_ce import fused_cross_entropy
from ray_tpu_torch.parallel import cache_stats, global_cache, stack_batches
from ray_tpu_torch.parallel.ring_attention import full_attention
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
from ray_tpu_torch.train import TrainStepRunner, array_checkpoint
from ray_tpu_torch.util import metrics, request_recorder, step_profiler

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12    # tensor cores, bf16 and fp16
PEAK_F32_FLOPS = 67e12      # CUDA cores, float32
PEAK_BYTES = 3.35e12        # HBM3

# Kernel vs plain tolerances. Both accumulate in f32 and round P to the
# value dtype before P.V, but the kernel rounds P against its running
# row max (the plain version against the final one) and sums in another
# order; O is then rounded to the input dtype, whose half-ulp at |O| ~ 2
# is 4e-3 (bf16) and 5e-4 (fp16). lse is f32 in both, from unrounded P.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float16: (4e-3, 1e-3),
       torch.float32: (1e-4, 1e-4)}
# Backward kernel vs plain, relative to each gradient's max. Both build
# P from the same lse and round dS and P where Pallas does; the f32 sums
# run in another order, so a dS element may round to the neighbouring
# bf16/fp16 value, and dq/dk/dv are rounded to the input dtype (half an
# ulp is 2e-3 of the max in bf16, 2.4e-4 in fp16).
BWD_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# First-token logits, flash prefill vs plain prefill, bf16 through every
# layer of the model: logits are ~N(0, 0.55) at init, and bf16 rounding
# differences in attention propagate through 12 residual blocks.
LOGIT_ATOL = 0.1
# Training, kernel path vs a full_attention model on the same weights
# (bf16 compute, B=4, T=1024), relative to each gradient's max (the loss:
# relative). full_attention rounds scores and probabilities to bf16 in its
# einsums where the kernels keep them in f32 and round P once, and the
# differences (a bf16 ulp is 3.9e-3) pass through 12 blocks forward and
# back, so a few ulps of the max are expected (PERF.md has the measured
# worst case).
GRAD_RTOL = 5e-2
LOSS_RTOL = 1e-3
# Training through TrainStepRunner (each step, or four, one CUDA graph)
# against the eager loop from the same weights and batch, step by step
# (relative): a replay runs the eager step's kernels on the same inputs,
# but the fused CE's `index_add_` adds dw's -onehot rows with atomics in
# a varying order, and capturable AdamW computes its bias corrections on
# the card in f32 where the eager optimizer takes Python floats; the last
# bits of an update differ, and bf16 compute carries that through the
# steps. The same bound holds K=4 against K=1 and a checkpoint's replayed
# steps against the first pass.
TRAJ_RTOL = 2e-3
# timed replays of each TrainStepRunner: K=1 (one step a replay) and K=4
GRAPH_RUNS = {1: 10, 4: 3}
# the checkpoint phase writes here (inside the checkout, gitignored) and
# removes it
CKPT_DIR = Path(__file__).resolve().parent / "smoke_ckpt"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: CUDA events around `iters` back-to-back
    calls (inputs stay L2-resident, as a prefill's fresh Q/K/V would)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, reps: int = 5) -> float:
    """Step time: host clock around work that ends in a synchronize
    (median of `reps`, after one warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _roofline(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the FLOPs over the peak rate of the units the kernels
    use for `dtype`."""
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def attention_bound(b, t, h, h_kv, d, dtype, causal):
    """Least time (ms) the card could take: the larger of the bytes the
    function must move (q, k, v read once; O and lse written once) over
    HBM bandwidth and its FLOPs (QK^T and PV over the (q, k) pairs this
    mask keeps) over the peak rate of the units the kernel uses."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * t * h * d + 2 * b * t * h_kv * d) * elt + b * h * t * 4
    pairs = t * (t + 1) / 2 if causal else t * t
    return _roofline(nbytes, 4.0 * b * h * d * pairs, dtype)


def attention_bwd_bound(b, t, h, h_kv, d, dtype, causal):
    """Least time (ms) the card could take for the backward: the larger
    of the bytes it must move (q, k, v, dO, lse and delta read once; dq,
    dk, dv written once) over HBM bandwidth and its least FLOPs over the
    peak rate: 10 * D per head and kept (q, k) pair, five products (QK^T,
    dO V^T, dS K, dS^T Q, P^T dO) with S and dP computed once. The
    two-kernel design executes 14 * D: it recomputes QK^T and dO V^T in
    both kernels."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (3 * b * t * h * d + 4 * b * t * h_kv * d) * elt \
        + 2 * b * h * t * 4
    pairs = t * (t + 1) / 2 if causal else t * t
    return _roofline(nbytes, 10.0 * b * h * d * pairs, dtype)


def _sdpa_layout(q, k, v):
    """[B, H, T, D] views for SDPA, with GQA KV repeated query-side."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if k.shape[2] != q.shape[2]:
        g = q.shape[2] // k.shape[2]
        kt = kt.repeat_interleave(g, dim=1)
        vt = vt.repeat_interleave(g, dim=1)
    return qt, kt, vt


def library_attention(q, k, v, causal):
    """One PyTorch call computing the same function (yardstick only)."""
    qt, kt, vt = _sdpa_layout(q, k, v)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def library_attention_bwd(q, k, v, do, causal):
    """SDPA forward with grad, and forward + backward (yardstick only):
    the backward's time is the difference of the two."""
    qt, kt, vt = (x.detach().requires_grad_()
                  for x in _sdpa_layout(q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return fwd, fwd_bwd


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
    ("copy/cast", ("copy", "Cat")),
    ("elementwise", ("elementwise",)),
)


def _kernel_class(name):
    return next((cls for cls, keys in KERNEL_CLASSES
                 if any(key in name for key in keys)), "other")


# the trace's warm-up (collection on, records dropped) and the recorded
# window's lead-in and tail last this long each around the profiled
# calls: a trace that opened at the first launch has come back without
# its first records (~100 kernels of a 4-step replay; after the
# checkpoint round trip, a marker launched 50 ms into the window)
PROFILE_PAD_S = 0.05
# the marker kernel launched at each end of the profiled calls
# (`torch.cuda._sleep`): both in the trace = no end of it was cut
MARKER_KERNEL = "spin_kernel"


def profile_steps(fn, steps: int):
    """Device time of `steps` calls of `fn` from a torch.profiler trace:
    per-step wall time, device busy time (the sum of kernel durations)
    and the busy share, the kernels that take the most time, and the
    device time by kind of kernel (`KERNEL_CLASSES`), and whether the
    trace is complete at both ends (a marker kernel before the calls and
    one after them are both in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()  # the warm-up ends: the recorded window opens
        time.sleep(PROFILE_PAD_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()  # the window closes
    by_name, markers = {}, 0
    for e in prof.events():
        # a user annotation (e.g. "Optimizer.step#AdamW.step") spans
        # kernels that are counted on their own
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        if MARKER_KERNEL in e.name:
            markers += 1
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.device_time_total)
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    by_class = {}
    for name, (_, us) in by_name.items():
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
    # each attention kernel function's device ms per step
    flash = {}
    for name, (_, us) in by_name.items():
        key = next((k[:-1] for k in FLASH_FWD_KERNELS + FLASH_BWD_KERNELS
                    if k in name), None)
        if key:
            flash[key] = flash.get(key, 0.0) + us / 1e3 / steps
    return dict(
        trace_complete=markers == 2, markers=markers,
        wall_ms=wall_us / 1e3 / steps,
        device_ms=busy_us / 1e3 / steps if busy_us else None,
        busy_share=busy_us / wall_us if busy_us else None,
        kernels_per_step=sum(n for n, _ in by_name.values()) / steps,
        flash_ms=sum(flash.values()),
        flash_bwd_ms=sum(ms for k, ms in flash.items()
                         if k + "<" in FLASH_BWD_KERNELS),
        flash_by_kernel=flash,
        # forward attention kernel executions per step (in a graph
        # replay as well: the trace lists each kernel node it ran)
        flash_fwd_per_step=sum(n for name, (n, _) in by_name.items()
                               if any(k in name for k in FLASH_FWD_KERNELS))
        / steps,
        # backward attention kernel executions per step (dQ and dK/dV)
        flash_bwd_per_step=sum(n for name, (n, _) in by_name.items()
                               if any(k in name for k in FLASH_BWD_KERNELS))
        / steps,
        by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top=[(name[:70], us / 1e3 / steps) for name, (_, us) in top])


def _whole(prof):
    """Whether a `profile_steps` trace is complete at both ends."""
    return ("trace complete at both ends" if prof["trace_complete"]
            else f"trace CUT at an end ({prof['markers']} of 2 end "
                 f"markers): its device numbers are short")


# -- phases -----------------------------------------------------------------


# ptxas' report of one kernel instance, e.g. "_ZN..8fwd_sm90I13__nv_bfloat16
# Li64ELi2EE..." (the function, its element type, its head_dim and, for the
# forward, its warpgroups)
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# which occupancy entry of `kernel_occupancy` each kernel function has
_OCCUPANCY_KEY = {"fwd_sm90": "fwd", "fwd_f32": "fwd", "dq_sm90": "bwd_dq",
                  "bwd_dq_f32": "bwd_dq", "dkv_sm90": "bwd_dkv",
                  "bwd_dkv_f32": "bwd_dkv"}
_PTXAS_NAME = re.compile(
    r"\d(" + "|".join(sorted(_OCCUPANCY_KEY, key=len, reverse=True))
    + r")I(13__nv_bfloat16|6__half|f)?Li(\d+)E(?:Li(\d+)E)?E")
_PTXAS_TYPES = {"13__nv_bfloat16": "bfloat16", "6__half": "float16",
                "f": "float32", None: "float32"}


def parse_ptxas(text):
    """Each kernel instance in nvcc's `-Xptxas -v` output: function,
    dtype, head_dim, registers, stack frame and spill bytes, and static
    shared memory (the kernels' tiles are dynamic shared memory, which
    ptxas does not see)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = _PTXAS_NAME.search(m.group(1))
            cur = dict(fn=name.group(1) if name else m.group(1),
                       dtype=_PTXAS_TYPES.get(name.group(2)) if name else None,
                       head_dim=int(name.group(3)) if name else None,
                       warpgroups=int(name.group(4) or 1) if name else None,
                       registers=None, stack_bytes=0, spill_store_bytes=0,
                       spill_load_bytes=0, smem_static_bytes=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_static_bytes"] = int(m.group(1)) if m else 0
    return rows


def phase_build():
    """Builds every source; returns (seconds, {source: [instance, ...]})
    with ptxas' numbers and the runtime's dynamic shared memory and
    blocks per SM for each kernel instance."""
    t0 = time.perf_counter()
    seconds = _build.build()
    wall = time.perf_counter() - t0
    print(f"build: {len(seconds)} source(s) compiled in {wall:.1f} s "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    occupancy = {(str(dt).replace("torch.", ""), d): kernel_occupancy(dt, d)
                 for dt in (torch.bfloat16, torch.float16, torch.float32)
                 for d in HEAD_DIMS}
    report = {}
    for name in _build.sources():
        log = _build.log_path(name)
        rows = parse_ptxas(log.read_text(errors="replace")) \
            if log.is_file() else []
        for r in rows:
            key = _OCCUPANCY_KEY.get(r["fn"])
            if r["warpgroups"] == 2:
                key = f"{key}_wg2"
            occ = occupancy.get((r["dtype"], r["head_dim"]), {}).get(key)
            r["smem_dynamic_bytes"], r["blocks_per_sm"] = occ or (None, None)
            print(f"  ptxas[{name}]: {r['fn']} {r['dtype']} d={r['head_dim']}"
                  f" wg={r['warpgroups']}: {r['registers']} registers, "
                  f"stack {r['stack_bytes']} B, spill "
                  f"{r['spill_store_bytes']}/{r['spill_load_bytes']} B "
                  f"(stores/loads); {r['smem_dynamic_bytes']} B dynamic "
                  f"shared memory, {r['blocks_per_sm']} blocks/SM")
        report[name] = rows
    return wall, report


GPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
GPT_PROMPT_LENS = [5, 17, 67, 104, 200, 333, 600, 900]
LLAMA_BUCKETS = GPT_BUCKETS + (2048,)
KERNEL_SHAPES = [
    # (label, b, t, h, h_kv, d, dtype, causal)
    *((f"gpt2 prefill T={t}", 1, t, 12, 12, 64, torch.bfloat16, True)
      for t in GPT_BUCKETS),
    ("ragged T=100", 1, 100, 12, 12, 64, torch.bfloat16, True),
    ("llama GQA 12:4 T=2048", 1, 2048, 12, 4, 64, torch.bfloat16, True),
    ("non-causal T=512", 1, 512, 12, 12, 64, torch.bfloat16, False),
    ("long T=4096", 1, 4096, 12, 12, 64, torch.bfloat16, True),
    ("fp16 d=128 T=777", 2, 777, 8, 2, 128, torch.float16, True),
    ("f32 T=256", 1, 256, 12, 12, 64, torch.float32, True),
    ("f32 d=128 T=300", 1, 300, 4, 4, 128, torch.float32, False),
    ("d=32 T=77", 2, 77, 2, 2, 32, torch.bfloat16, True),
    ("f32 d=16 T=50", 1, 50, 4, 2, 16, torch.float32, True),
    ("gpt2 train B=16 T=1024", 16, 1024, 12, 12, 64, torch.bfloat16, True),
    ("llama GQA 12:4 B=16 T=1024", 16, 1024, 12, 4, 64, torch.bfloat16,
     True),
    ("long B=4 T=4096", 4, 4096, 12, 12, 64, torch.bfloat16, True),
]
MAIN_SHAPE = "gpt2 prefill T=1024"
TRAIN_SHAPE = "gpt2 train B=16 T=1024"
# the shapes the train_llama and train_long paths give both kernels
TRAIN_LLAMA_SHAPE = "llama GQA 12:4 B=16 T=1024"
TRAIN_LONG_SHAPE = "long B=4 T=4096"
BWD_SHAPES = [
    # (label, b, t, h, h_kv, d, dtype, causal)
    (TRAIN_SHAPE, 16, 1024, 12, 12, 64, torch.bfloat16, True),
    ("llama GQA 12:4 B=16 T=1024", 16, 1024, 12, 4, 64, torch.bfloat16,
     True),
    ("long B=4 T=4096", 4, 4096, 12, 12, 64, torch.bfloat16, True),
    ("non-causal B=4 T=1024", 4, 1024, 12, 12, 64, torch.bfloat16, False),
    ("ragged B=2 T=1000", 2, 1000, 12, 12, 64, torch.bfloat16, True),
    ("fp16 d=128 B=2 T=777", 2, 777, 8, 2, 128, torch.float16, True),
    ("f32 d=32 B=2 T=300", 2, 300, 4, 2, 32, torch.float32, True),
    ("f32 d=16 B=1 T=50", 1, 50, 4, 2, 16, torch.float32, False),
]


def phase_kernels(gen):
    rows = []
    with torch.inference_mode():
        for label, b, t, h, h_kv, d, dtype, causal in KERNEL_SHAPES:
            q = torch.randn(b, t, h, d, generator=gen, device="cuda")
            k = torch.randn(b, t, h_kv, d, generator=gen, device="cuda")
            v = torch.randn(b, t, h_kv, d, generator=gen, device="cuda")
            q, k, v = (x.to(dtype) for x in (q, k, v))
            out, lse = flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
            ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), label
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            tol_o, tol_lse = TOL[dtype]
            assert err <= tol_o and lse_err <= tol_lse, (
                f"{label}: kernel disagrees with plain: O err {err} "
                f"(tol {tol_o}), lse err {lse_err} (tol {tol_lse})")
            iters = 5 if t * b >= 2048 else 20
            ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                         iters)
            plain_ms = cuda_ms(
                lambda: flash_attention_plain(q, k, v, causal=causal),
                iters)
            lib_ms = cuda_ms(library_attention(q, k, v, causal), iters)
            bound_ms, bound_by = attention_bound(b, t, h, h_kv, d, dtype,
                                                 causal)
            row = dict(shape=label, b=b, t=t, h=h, h_kv=h_kv, d=d,
                       dtype=str(dtype).replace("torch.", ""),
                       causal=causal, route=kernel_routes(dtype)["fwd"],
                       max_abs_err=err, lse_err=lse_err,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print(f"kernel {label:24s} [{row['route']}] O err {err:.2e} "
                  f"lse err {lse_err:.2e} | kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms | bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}) = "
                  f"{bound_ms / ms:.1%} of roofline")
    return rows


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def phase_backward(gen, device="cuda"):
    rows = []
    # no_grad, not inference_mode: the SDPA yardstick needs autograd
    with torch.no_grad():
        for label, b, t, h, h_kv, d, dtype, causal in BWD_SHAPES:
            q, k, v, do = (torch.randn(b, t, n, d, generator=gen,
                                       device=device).to(dtype)
                           for n in (h, h_kv, h_kv, h))
            out, lse = flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
            got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
            torch.cuda.synchronize()
            errs = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.shape == w.shape and g.dtype == dtype, label
                assert torch.isfinite(g.float()).all(), (label, name)
                errs[name] = (float((g.float() - w.float()).abs().max()),
                              _rel_err(g, w))
            worst = max(rel for _, rel in errs.values())
            assert worst <= BWD_TOL[dtype], (
                f"{label}: backward kernel disagrees with plain: {errs} "
                f"(tol {BWD_TOL[dtype]} of each gradient's max)")
            del got, want
            iters = 5 if b * t >= 4096 else 20
            ms = cuda_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, do, causal=causal), iters)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal=causal), iters)
            with torch.enable_grad():
                fwd, fwd_bwd = library_attention_bwd(q, k, v, do, causal)
                lib_fwd_ms = cuda_ms(fwd, iters)
                lib_fwd_bwd_ms = cuda_ms(fwd_bwd, iters)
            bound_ms, bound_by = attention_bwd_bound(b, t, h, h_kv, d,
                                                     dtype, causal)
            row = dict(shape=label, b=b, t=t, h=h, h_kv=h_kv, d=d,
                       dtype=str(dtype).replace("torch.", ""),
                       causal=causal, route=kernel_routes(dtype)["bwd"],
                       max_abs_err=max(e for e, _ in errs.values()),
                       rel_err={n: r for n, (_, r) in errs.items()},
                       ms=ms, plain_ms=plain_ms,
                       library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
                       library_fwd_ms=lib_fwd_ms,
                       library_fwd_bwd_ms=lib_fwd_bwd_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print(f"backward {label:28s} [{row['route']}] rel err dq/dk/dv "
                  f"{'/'.join(f'{r:.1e}' for _, r in errs.values())} | "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa bwd "
                  f"{row['library_ms']:.4f} ms (fwd+bwd {lib_fwd_bwd_ms:.4f}"
                  f" - fwd {lib_fwd_ms:.4f}) | bound {bound_ms * 1e3:.2f} "
                  f"us ({bound_by}) = {bound_ms / ms:.1%} of roofline")
    return rows


# the families the training phases run: (module, model class)
TRAIN_FAMILIES = {"gpt": (gpt_mod, gpt_mod.GPT),
                  "llama": (llama_mod, llama_mod.Llama)}


def _train_setup(family, cfg, seed, batch, seq, attention_fn, device):
    """A trainable model of `family` with fresh f32 master weights (from
    `seed`) and one fixed random token batch from numpy."""
    mod, net_cls = TRAIN_FAMILIES[family]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mod.init_params(cfg, gen, device=device, dtype=torch.float32)
    model = net_cls.from_params(cfg, params, attention_fn=attention_fn,
                                trainable=True)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq + 1))
    toks = torch.from_numpy(toks).to(device)
    return model, toks[:, :-1], toks[:, 1:]


def _loss(model, inputs, targets):
    hidden, wte = model(inputs, return_hidden=True)
    return fused_cross_entropy(hidden, wte, targets)


def _adamw_carry(model, opt):
    """The graphed step's carry: the parameters (f32 masters) and
    AdamW's state, created here as AdamW would create it at its first
    step (capturable: `step` a tensor on the parameter's device), so the
    first call's signature is that of every later call."""
    params = dict(model.named_parameters())
    for p in params.values():
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=p.device),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return {"params": params,
            **{key: {n: opt.state[p][key] for n, p in params.items()}
               for key in ("exp_avg", "exp_avg_sq", "step")}}


def _traj_err(got, want):
    """Worst relative difference of two loss trajectories over their
    common steps."""
    n = min(len(got), len(want))
    return max(abs(g - w) / abs(w) for g, w in zip(got[:n], want[:n]))


def _graphed_train(name, family, cfg, seed, batch, seq, k, flash, device,
                   checkpoint=False):
    """Trains `cfg` from the eager loop's initial weights and batch
    through `TrainStepRunner(step, steps_per_call=k)`: the step (forward,
    fused CE backward, AdamW(capturable=True)) is captured as one CUDA
    graph of k steps. The first run is the miss (the steps run eagerly,
    then the capture), then `GRAPH_RUNS[k]` timed replays with the launch
    counts set to 0 just before and read just after. With `checkpoint`, the
    carry is saved with `array_checkpoint` after step 5, five steps run,
    the checkpoint is copied back into the live carry (checked equal to
    the saved carry, leaf by leaf) and the same five steps run again (all
    before the timed replays). Ends with a profiled replay, which must
    list every attention kernel, and evicts the graph."""
    mod = TRAIN_FAMILIES[family][0]
    runs = GRAPH_RUNS[k]
    gc.collect()
    torch.cuda.empty_cache()
    model, inputs, targets = _train_setup(family, cfg, seed, batch, seq,
                                          flash, device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4,
                            capturable=torch.device(device).type == "cuda")
    carry = _adamw_carry(model, opt)

    def train_step(carry, data):
        loss = _loss(model, data["x"], data["y"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, loss.detach()

    data = {"x": inputs, "y": targets}
    if k > 1:
        data = stack_batches([data] * k)
    tokens = batch * seq
    runner = TrainStepRunner(
        train_step, steps_per_call=k, tokens_per_step=tokens,
        flops_per_step=mod.flops_per_token(cfg, seq) * tokens,
        peak_flops=PEAK_BF16_FLOPS, device=device)
    losses, calls = [], 0

    def run():
        nonlocal carry, calls
        carry, loss = runner.run(carry, data)
        calls += 1
        # the static output: the next replay overwrites it
        losses.append(loss.detach().clone().reshape(-1))

    stats0, records0 = cache_stats(), step_profiler.ring().total_recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    run()  # the miss: k eager steps, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # a miss takes exactly one call's steps (k), never a second
    steps_after_miss = {float(s) for s in carry["step"].values()}
    assert steps_after_miss == {float(k)}, steps_after_miss
    stats1 = cache_stats()
    assert stats1["misses"] == stats0["misses"] + 1, (stats0, stats1)
    assert stats1["retraces"] == stats0["retraces"], (stats0, stats1)
    # the eager run's blocks go back; the graph's private pool stays
    torch.cuda.empty_cache()
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30

    ckpt = None
    if checkpoint:  # at k=1
        for _ in range(4):
            run()
        path = CKPT_DIR
        shutil.rmtree(path, ignore_errors=True)
        saved = [x.detach().clone() for x in _tensor_leaves(carry)]
        t1 = time.perf_counter()
        array_checkpoint.save_sharded(str(path), carry)
        save_s = time.perf_counter() - t1
        assert array_checkpoint.is_usable(str(path))
        for _ in range(5):
            run()
        first = torch.cat(losses[-5:]).tolist()
        t1 = time.perf_counter()
        restored = array_checkpoint.restore_sharded(str(path), carry)
        with torch.no_grad():
            for got, want in zip(_tensor_leaves(restored),
                                 _tensor_leaves(carry)):
                want.copy_(got)
        restore_s = time.perf_counter() - t1
        # the restore is exact: every parameter and AdamW moment and step
        # count is bit for bit the saved one
        exact = [torch.equal(x, y) for x, y in zip(_tensor_leaves(carry),
                                                   saved)]
        assert all(exact), f"{exact.count(False)} leaves differ"
        del restored, saved
        shutil.rmtree(path, ignore_errors=True)
        for _ in range(5):
            run()
        again = torch.cat(losses[-5:]).tolist()
        del losses[-5:]  # the trajectory keeps the first pass
        err = _traj_err(again, first)
        print(f"{name}: checkpoint after step 5 ({save_s:.2f} s to save, "
              f"{restore_s:.2f} s to restore into the live carry, all "
              f"{len(exact)} leaves bit-identical to the saved ones): steps "
              f"6-10 {[round(x, 4) for x in first]} then again "
              f"{[round(x, 4) for x in again]}, worst rel {err:.2e} (tol "
              f"{TRAJ_RTOL})")
        assert err <= TRAJ_RTOL, (first, again)
        ckpt = dict(save_s=save_s, restore_s=restore_s,
                    exact_leaves=len(exact), first=first,
                    again=again, rel_err=err)

    # the main path: counts at 0 just before, read just after
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    hits0 = cache_stats()["hits"]
    t0 = time.perf_counter()
    for _ in range(runs):
        run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd_launches = flash_attention.launches
    bwd_launches = flash_attention_bwd.launches
    steps = runs * k
    stats2 = cache_stats()
    assert stats2["hits"] == hits0 + runs, (hits0, stats2)
    assert stats2["misses"] == stats1["misses"], (stats1, stats2)
    assert stats2["retraces"] == stats0["retraces"], (stats0, stats2)
    assert fwd_launches == cfg.n_layer * steps, fwd_launches
    assert bwd_launches == cfg.n_layer * steps * BWD_KERNELS_PER_CALL, \
        bwd_launches
    # one step record per run; the timed runs' split of each run's time
    records = step_profiler.ring().total_recorded - records0
    assert records == calls, (records, calls)
    split = {key: statistics.median(r[key] for r in runner.step_stats(runs))
             for key in ("total_ms", "host_dispatch_ms",
                         "device_execute_ms")}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.cat(losses).tolist()
    assert all(np.isfinite(losses)), losses
    step_ms = elapsed / steps * 1e3
    tok_s = tokens * steps / elapsed
    mfu = mod.flops_per_token(cfg, seq) * tok_s / PEAK_BF16_FLOPS
    prof = profile_steps(lambda: runner.run(carry, data), 1)
    # the replay's trace lists every attention kernel it ran
    assert prof["flash_fwd_per_step"] == cfg.n_layer * k, prof
    assert prof["flash_bwd_per_step"] == \
        cfg.n_layer * k * BWD_KERNELS_PER_CALL, prof
    assert global_cache().evict(runner._compiled) == 1
    del runner, model, opt, carry, data, train_step
    gc.collect()
    torch.cuda.empty_cache()
    busy = "not measured" if prof["busy_share"] is None else (
        f"{prof['device_ms']:.2f} ms device busy per step = "
        f"{prof['busy_share']:.1%} of the profiled replay")
    print(f"{name} K={k}: graphed, {steps} steps in {runs} replays in "
          f"{elapsed:.3f} s = {step_ms:.2f} ms/step, {tok_s:.0f} tok/s, MFU "
          f"{mfu:.1%} of 989 TFLOP/s bf16; miss ({k} eager step(s) + "
          f"capture) {capture_s:.2f} s; graph pool {pool_gib:.2f} GiB "
          f"(memory_reserved {reserved0 / 2**30:.2f} GiB before); peak "
          f"memory {peak_gib:.2f} GiB; launches fwd {fwd_launches} bwd "
          f"{bwd_launches}; profile: {busy}, {prof['kernels_per_step']:.0f} "
          f"kernels/replay ({_whole(prof)}), flash fwd/bwd kernels per replay "
          f"{prof['flash_fwd_per_step']:.0f}/{prof['flash_bwd_per_step']:.0f};"
          f" step records of the timed runs, median: {split['total_ms']} ms "
          f"a run = {split['host_dispatch_ms']} ms host dispatch (the call "
          f"up to its return) + {split['device_execute_ms']} ms to the "
          f"synchronize after it (card: {card_line()})")
    return dict(k=k, runs=runs, steps=steps, losses=losses,
                capture_s=capture_s, pool_gib=pool_gib,
                reserved_before_gib=reserved0 / 2**30, step_ms=step_ms,
                tokens_per_s=tok_s, mfu=mfu, peak_mem_gib=peak_gib,
                fwd_launches=fwd_launches, bwd_launches=bwd_launches,
                step_records=records, run_split_ms=split, profile=prof,
                checkpoint=ckpt)


def _tensor_leaves(tree):
    """The tensor leaves of a dict/list/tuple tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _tensor_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _tensor_leaves(item)]
    return [tree]


def phase_train(name="train", family="gpt", seed=3, batch=16, seq=1024,
                steps=10, grad_batch=4, cfg=None, device="cuda",
                checkpoint=False):
    """Trains `cfg` (default GPT-2 125M, remat off, T=`seq`) as
    `bench.py` does: a warm step, then `steps` timed steps, the launch
    counts read just after them, a profiled step, and the kernel path's
    loss and gradients at B=`grad_batch` against `full_attention`'s.
    Then from the same weights and batch through `TrainStepRunner` at
    K=1 and K=4 steps per graph (`GRAPH_RUNS` timed replays each; with
    `checkpoint`, the K=1 run's array-checkpoint round trip)."""
    cfg = cfg or gpt_mod.GPTConfig.gpt2_125m(remat=False, max_seq_len=seq)
    mod = TRAIN_FAMILIES[family][0]
    print(f"{name}: {cfg}, B={batch}, T={seq}")
    views = {}

    def flash(q, k, v):
        # the q/k/v views one block hands the kernels (read in place)
        views.setdefault("strides", {n: tuple(x.stride()) for n, x in
                                     (("q", q), ("k", k), ("v", v))})
        return flash_attention(q, k, v, causal=True)

    model, inputs, targets = _train_setup(family, cfg, seed, batch, seq,
                                          flash, device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def step():
        loss = _loss(model, inputs, targets)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    t0 = time.perf_counter()
    losses = [step()]  # the warm step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    fwd_launches = flash_attention.launches
    bwd_launches = flash_attention_bwd.launches

    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert fwd_launches == cfg.n_layer * steps, fwd_launches
    assert bwd_launches == cfg.n_layer * steps * BWD_KERNELS_PER_CALL, \
        bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = elapsed / steps * 1e3
    tok_s = batch * seq * steps / elapsed
    mfu = mod.flops_per_token(cfg, seq) * tok_s / PEAK_BF16_FLOPS
    prof = profile_steps(step, 1)
    del model, opt, step
    torch.cuda.empty_cache()

    # the kernel path's loss and gradients against full_attention's
    grads, grad_losses = {}, {}
    for key, fn in (("flash", flash),
                    ("full", partial(full_attention, causal=True))):
        net, x, y = _train_setup(family, cfg, seed + 1, grad_batch, seq, fn,
                                 device)
        loss = _loss(net, x, y)
        loss.backward()
        grad_losses[key] = float(loss.detach())
        grads[key] = {n: p.grad for n, p in net.named_parameters()}
        del net, loss
        torch.cuda.empty_cache()
    worst_name, worst = max(
        ((n, _rel_err(grads["flash"][n], grads["full"][n]))
         for n in grads["full"]), key=lambda kv: kv[1])
    loss_rel = abs(grad_losses["flash"] - grad_losses["full"]) / abs(
        grad_losses["full"])
    assert all(torch.isfinite(g).all() for g in grads["flash"].values())
    assert worst <= GRAD_RTOL, (worst_name, worst)
    assert loss_rel <= LOSS_RTOL, grad_losses
    del grads
    torch.cuda.empty_cache()

    busy = "not measured" if prof["busy_share"] is None else (
        f"{prof['device_ms']:.2f} ms device busy = "
        f"{prof['busy_share']:.1%} of the profiled step, "
        f"{prof['device_ms'] / step_ms:.1%} of the unprofiled one; flash "
        f"fwd+bwd {prof['flash_ms']:.2f} ms "
        f"({prof['flash_ms'] / prof['device_ms']:.1%} of device time; "
        f"bwd {prof['flash_bwd_ms']:.2f} ms; by kernel "
        f"{ {k: round(v, 2) for k, v in prof['flash_by_kernel'].items()} })")
    print(f"{name}: losses {[round(x, 4) for x in losses]}")
    print(f"{name}: warm step {warm_s:.2f} s; {steps} steps in "
          f"{elapsed:.3f} s = {step_ms:.2f} ms/step, {tok_s:.0f} tok/s, MFU "
          f"{mfu:.1%} of 989 TFLOP/s bf16 (card: {card_line()}); peak "
          f"memory {peak_gib:.2f} GiB; launches fwd {fwd_launches} bwd "
          f"{bwd_launches}; q/k/v strides {views['strides']}")
    print(f"{name}: profile: {prof['wall_ms']:.2f} ms/step wall, {busy}, "
          f"{prof['kernels_per_step']:.0f} kernels/step ({_whole(prof)}); "
          f"device ms by kind "
          f"{ {k: round(v, 2) for k, v in prof['by_class'].items()} }; top "
          f"{prof['top']}")
    print(f"{name}: B={grad_batch} kernel path vs full_attention: loss "
          f"{grad_losses['flash']:.5f} vs {grad_losses['full']:.5f} "
          f"(rel {loss_rel:.1e}); worst gradient {worst_name} "
          f"{worst:.2e} of its max (tol {GRAD_RTOL})")

    # the same model and batch through TrainStepRunner: each step one
    # graph (K=1), then four steps one graph (K=4)
    graphed = {}
    for k in GRAPH_RUNS:
        graphed[f"k{k}"] = g = _graphed_train(
            name, family, cfg, seed, batch, seq, k, flash, device,
            checkpoint=checkpoint and k == 1)
        # K=1 against the eager loop, K=4 against K=1, step by step
        want = graphed["k1"]["losses"] if k > 1 else losses
        err = _traj_err(g["losses"], want)
        print(f"{name} K={k}: losses {[round(x, 4) for x in g['losses']]}; "
              f"worst rel difference from {'K=1' if k > 1 else 'eager'} "
              f"over the first {min(len(g['losses']), len(want))} steps "
              f"{err:.2e} (tol {TRAJ_RTOL})")
        assert err <= TRAJ_RTOL, (k, g["losses"], want)
        g["traj_rel_err"] = err

    return dict(phase=name, family=family, n_layer=cfg.n_layer,
                batch=batch, seq=seq, steps=steps, remat=cfg.remat,
                losses=losses, warm_s=warm_s, step_ms=step_ms,
                tokens_per_s=tok_s, mfu=mfu, peak_mem_gib=peak_gib,
                fwd_launches=fwd_launches, bwd_launches=bwd_launches,
                qkv_strides=views["strides"], profile=prof,
                grad_check=dict(batch=grad_batch, losses=grad_losses,
                                loss_rel=loss_rel, worst=worst,
                                worst_param=worst_name, tol=GRAD_RTOL),
                graphed=graphed)


def _top2_gap(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


class _SmokeEngine(LLMEngine):
    """The engine, keeping each request's first-token logits for the
    plain-attention check and, with `record_gaps`, the top-2 logit gap
    behind each token it emits (the near ties of the token comparisons).
    It reads each graph output before the next replay overwrites it."""

    def __init__(self, *a, record_gaps=False, **kw):
        super().__init__(*a, **kw)
        self.first_logits = {}
        self.record_gaps = record_gaps
        self.gaps = {}  # request id -> [gap of token 0, token 1, ...]

    def _emit_first(self, seq, next_logits_row):
        self.first_logits[seq.req.id] = next_logits_row.float().cpu()
        if self.record_gaps:
            self.gaps[seq.req.id] = [float(_top2_gap(next_logits_row))]
        return super()._emit_first(seq, next_logits_row)

    def _decode(self, *a, **kw):
        out = super()._decode(*a, **kw)
        if self.record_gaps:
            self._step_gaps = _top2_gap(out[0]).tolist()
        return out

    def _decode_once(self):
        runs = list(self._running)
        n = super()._decode_once()
        if self.record_gaps:
            for seq, gap in zip(runs, self._step_gaps):
                self.gaps[seq.req.id].append(gap)
        return n


class _EagerEngine(_SmokeEngine):
    """The graphs' yardstick: the same engine calling every step function
    eagerly (`fn.__wrapped__`, its host inputs moved to the card), so no
    graph is captured or replayed."""

    def _run(self, fn, *args):
        return fn.__wrapped__(*(a.to(self.device) for a in args))


def _prompts(cfg, prompt_lens, seed):
    """The engine phases' prompts: random tokens from numpy, the 3rd and
    4th sharing a 64-token prefix (the prefix-cache chunk path runs)."""
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(1, cfg.vocab_size, 64))
    prompts = []
    for i, n in enumerate(prompt_lens):
        if i in (2, 3):
            prompts.append(shared + list(rng.integers(1, cfg.vocab_size,
                                                      n - 64)))
        else:
            prompts.append(list(rng.integers(1, cfg.vocab_size, n)))
    return [[int(x) for x in p] for p in prompts]


def _capture(eng):
    """`eng.warmup()`, which captures one graph per bucket: the seconds
    it took, the graphs, and the memory they hold (static buffers and
    pool: reserved memory after minus before, unused cached blocks
    released around it)."""
    entries = global_cache().size()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    graphs = global_cache().size() - entries
    assert graphs == len(eng._step_fns()), (graphs, len(eng._step_fns()))
    return dict(capture_s=seconds, graphs=graphs,
                graph_mib=(torch.cuda.memory_reserved() - reserved) / 2**20)


def _check_cache(before, after, calls):
    """Steady state is all replays: no miss after warmup(), no retrace,
    and one hit per compiled step call of the run."""
    assert after["misses"] == before["misses"], (before, after)
    assert after["retraces"] == 0, after
    assert after["hits"] - before["hits"] == sum(calls.values()), (
        before, after, calls)


def _bucket_inputs(eng, gen):
    """(name, compiled step function, host arguments) for every bucket of
    `eng`: random tokens, positions and page tables over the arena as the
    run left it."""
    cfg = eng.model_cfg

    def ints(*shape, low=0, high):
        return torch.randint(low, high, shape, generator=gen)

    out = []
    for draft in (False, True) if eng.kv_d is not None else (False,):
        kv = eng.kv_d if draft else eng.kv
        width = eng.max_pages_per_seq_d if draft else eng.max_pages_per_seq
        for s, fn in (eng._d_prefill_fns if draft
                      else eng._prefill_fns).items():
            out.append((fn, (ints(1, s, high=cfg.vocab_size),
                             ints(1, low=1, high=s + 1))))
        for b, fn in (eng._d_decode_fns if draft
                      else eng._decode_fns).items():
            out.append((fn, (ints(b, high=cfg.vocab_size),
                             ints(b, low=1, high=cfg.max_seq_len),
                             kv.k_pages, kv.v_pages,
                             ints(b, width, high=kv.num_pages))))
        fn, c = (eng._d_chunk_fn if draft else eng._chunk_fn), eng._chunk_size
        out.append((fn, (ints(1, c, high=cfg.vocab_size),
                         ints(1, high=cfg.max_seq_len - c + 1),
                         kv.k_pages, kv.v_pages,
                         ints(1, width, high=kv.num_pages))))
    if eng.kv_d is not None:
        k1 = eng.config.spec_k + 1
        for b, fn in eng._verify_fns.items():
            out.append((fn, (ints(b, k1, high=cfg.vocab_size),
                             ints(b, high=cfg.max_seq_len - k1 + 1),
                             eng.kv.k_pages, eng.kv.v_pages,
                             ints(b, eng.max_pages_per_seq,
                                  high=eng.kv.num_pages))))
    return [(fn.__name__, fn, args) for fn, args in out]


def _check_buckets(eng, seed):
    """Every captured bucket against its eager step function on the same
    inputs and arena: logits within LOGIT_ATOL, argmax equal unless the
    eager top-2 gap is a near tie (within LOGIT_ATOL), K/V within two
    bf16 ulps of their largest magnitude (2^-7 of it). Returns each
    bucket's worst logit difference."""
    gen = torch.Generator().manual_seed(seed)
    worst = {}
    with torch.inference_mode():
        for name, fn, args in _bucket_inputs(eng, gen):
            got = [x.clone() for x in fn(*args)]  # the next replay reuses
            want = fn.__wrapped__(*(a.to(eng.device) for a in args))
            logits, wlogits = got[0].float(), want[0].float()
            assert torch.isfinite(logits).all(), name
            diff = float((logits - wlogits).abs().max())
            assert diff <= LOGIT_ATOL, (name, diff)
            split = logits.argmax(-1) != wlogits.argmax(-1)
            assert bool((_top2_gap(wlogits)[split] <= LOGIT_ATOL).all()), name
            for g, w in zip(got[1:], want[1:]):
                err = float((g.float() - w.float()).abs().max())
                assert err <= 2.0 ** -7 * float(w.float().abs().max()), (
                    name, err)
            worst[name] = diff
    return worst


def _near_tie_compare(outs, want, gaps, label):
    """Tokens against a reference run's: a token may differ only where
    the reference's top-2 logit gap there is within LOGIT_ATOL (bf16
    rounds a near tie either way); that request's comparison stops
    there. Returns (tokens compared, [near-tie stops])."""
    ties, compared = [], 0
    for i, (got, w, g) in enumerate(zip(outs, want, gaps)):
        for j, (a, b) in enumerate(zip(got, w)):
            if a != b:
                assert g[j] <= LOGIT_ATOL, (
                    f"{label}: request {i} token {j} is {a}, the "
                    f"reference's {b} with a top-2 gap of {g[j]} (> "
                    f"{LOGIT_ATOL}: not a near tie)")
                ties.append(dict(request=i, token=j, gap=g[j]))
                break
            compared += 1
    return compared, ties


def _step_times(eng, cfg, buckets):
    """Host-clock ms of one prefill per bucket and of a batch-8 decode
    (its argmax to the host, as the engine does), and profiles of both
    at the largest bucket."""
    prefill_ms = {}
    with torch.inference_mode():
        for s in buckets:
            prefill_ms[s] = host_ms(lambda: eng._prefill([[1] * s], [s]))
        table = [list(range(i * eng.max_pages_per_seq,
                            (i + 1) * eng.max_pages_per_seq))
                 for i in range(8)]

        def decode_b8():
            return torch.argmax(eng._decode(
                [1] * 8, [cfg.max_seq_len // 2] * 8, table)[0], -1).tolist()

        top = max(buckets)
        decode_ms = host_ms(decode_b8)
        profiles = {
            "decode_b8": profile_steps(decode_b8, 10),
            f"prefill_{top}": profile_steps(
                lambda: eng._prefill([[1] * top], [top]), 3)}
    return prefill_ms, decode_ms, profiles


def _observed(eng, reqs, steps_before, hits):
    """The engine's observability after a run: one request-recorder
    engine record per request with its phases tiling the total (within
    5 %), the port registry's `serve_llm_*` and `compile_cache_*` lines
    with the run's counts, one step-profiler record per engine step, and
    a pump probe that beat and never stalled."""
    m = eng.metrics()
    records = [r for r in request_recorder.ring().recent()
               if r.role == "engine"]
    assert len(records) == len(reqs), len(records)
    ratios = [r.phase_sum_ms() / r.total_ms for r in records]
    assert all(0.95 <= x <= 1.05 for x in ratios), [r.as_dict() for r in records]
    assert all(r.outcome == "ok" and r.ttft_ms > 0 for r in records)
    text = metrics.DEFAULT_REGISTRY.prometheus_text()
    for line in (f"serve_llm_tokens_generated_total "
                 f"{int(m['tokens_generated'])}",
                 f"serve_llm_requests_completed_total {len(reqs)}",
                 f"compile_cache_hits_total {hits}",
                 "compile_cache_retraces_total 0",
                 *(f'serve_llm_compiled_step_calls_total{{kind="{k}",'
                   f'bucket="{b}"}} {n}' for k, b, n in (
                       (*key.rsplit(":", 1), n) for key, n in
                       m["compiled_step_calls"].items()))):
        assert line in text.splitlines(), line
    steps = step_profiler.ring().total_recorded - steps_before
    assert steps == eng._step_no, (steps, eng._step_no)
    step_ms = sorted(r["total_ms"] for r in step_profiler.recent(steps))
    probe = eng._pump_probe
    assert probe.count > 0 and probe.stalls_total == 0, (
        probe.count, probe.stalls_total)
    return dict(records=len(records), phase_ratio=(min(ratios),
                                                   max(ratios)),
                ttft_ms=sorted(r.ttft_ms for r in records),
                tpot_ms=sorted(r.tpot_ms for r in records if r.tpot_ms),
                step_records=steps, step_ms_p50=step_ms[len(step_ms) // 2],
                step_ms_max=step_ms[-1],
                # host clock of the run's decode passes, per step: the
                # replay, the argmax sync and the per-lane K/V appends
                decode_ms_per_step=m["decode_ms"] / m["decode_steps"],
                prefill_ms_per_step=m["prefill_ms"] / m["prefill_steps"],
                pump_beats=probe.count, pump_stalls=probe.stalls_total)


def _serve(eng, prompts, max_new):
    """Serves `prompts` through the engine's pump thread, as a replica
    would, with the launch counts set to 0 just before; returns (requests,
    outputs, seconds, forward kernel launches)."""
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    eng.start()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    outs = [r.result(timeout=600) for r in reqs]
    gen_s = time.perf_counter() - t0
    eng.quiesce()
    eng.stop()
    assert flash_attention_bwd.launches == 0  # serving runs no backward
    for r, out in zip(reqs, outs):
        assert r.finish_reason == "length" and len(out) == max_new, (
            r.id, r.finish_reason, len(out))
    return reqs, outs, gen_s, flash_attention.launches


def _mib(nbytes):
    return round(nbytes / 2**20, 1)


def _allocated():
    """Bytes the caching allocator has handed out, after dropping cuBLAS'
    per-(handle, stream) workspaces: a new thread or stream (a pump
    thread, the capture stream) adds one that the process keeps."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_engine(name, mod, cfg, net_cls, buckets, prompt_lens, max_new,
                 seed, device="cuda"):
    """Serves the prompts through the engine with every bucket a captured
    CUDA graph, then through an engine calling the same step functions
    eagerly, and holds one to the other (see the module docstring)."""
    print(f"engine[{name}]: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = mod.init_params(cfg, gen, device=device)
    ecfg = EngineConfig(batch_buckets=(1, 2, 4, 8), prefill_buckets=buckets)
    entries_before = global_cache().size()
    mem_before = _allocated()
    t0 = time.perf_counter()
    eng = _SmokeEngine(model=name, model_cfg=cfg, params=params,
                       device=device, engine_config=ecfg)
    capture = _capture(eng)
    warmup_s = time.perf_counter() - t0
    prompts = _prompts(cfg, prompt_lens, seed)

    # the main path: counts at 0 just before (in _serve), read just after
    stats0 = cache_stats()
    request_recorder.clear()
    steps_before = step_profiler.ring().total_recorded
    reqs, outs, gen_s, launches = _serve(eng, prompts, max_new)
    stats1 = cache_stats()
    m = eng.metrics()
    calls = m["compiled_step_calls"]
    _check_cache(stats0, stats1, calls)
    prefill_calls = {int(key.split(":")[1]): c for key, c in calls.items()
                     if key.startswith("prefill:")}
    prefills = sum(prefill_calls.values())
    for out in outs:
        assert all(0 <= t < cfg.vocab_size for t in out)
    assert launches == cfg.n_layer * prefills > 0, (launches, prefills)
    assert m["prefix_cache_hits"] >= 1, m  # the shared-prefix chunk path
    observed = _observed(eng, reqs, steps_before, stats1["hits"])

    # first-token logits against a plain-attention prefill on the card
    plain = net_cls.from_params(cfg, params, attention_fn=full_attention)
    worst = 0.0
    with torch.inference_mode():
        for r, p in zip(reqs, prompts):
            s = len(p)
            bucket = min(b for b in buckets if b >= s)
            toks = torch.tensor([p + [0] * (bucket - s)], device=device)
            want, _, _ = mod.prefill_step(plain, cfg, toks,
                                          torch.tensor([s], device=device))
            want = want[0].float().cpu()
            got = eng.first_logits[r.id]
            assert torch.isfinite(got).all()
            diff = float((got - want).abs().max())
            worst = max(worst, diff)
            assert diff <= LOGIT_ATOL, (r.id, s, diff)
            # the emitted token is a top choice of the plain logits too
            assert float(want[r.tokens[0]]) >= float(want.max()) - \
                2 * LOGIT_ATOL, (r.id, s)
    del plain

    # each captured bucket against its eager step function
    bucket_diff = _check_buckets(eng, seed)
    graphed = _step_times(eng, cfg, buckets)
    # a profiled prefill replay ran the forward kernel once per layer
    top_profile = graphed[2][f"prefill_{max(buckets)}"]
    assert top_profile["flash_fwd_per_step"] == cfg.n_layer, top_profile

    # the same prompts through the eager engine: the graphs' tokens
    eager = _EagerEngine(model=name, model_cfg=cfg, params=params,
                         device=device, engine_config=ecfg,
                         record_gaps=True)
    eager.warmup()
    eager_reqs, want, eager_s, _ = _serve(eager, prompts, max_new)
    compared, ties = _near_tie_compare(
        outs, want, [eager.gaps[r.id] for r in eager_reqs],
        f"engine[{name}]")
    eager_times = _step_times(eager, cfg, buckets)

    leaked = eng.shutdown() + eager.shutdown()
    assert leaked == 0, f"{leaked} KV pages leaked"
    del eng, eager
    mem_after = _allocated()
    assert global_cache().size() == entries_before  # graphs evicted
    assert mem_after - mem_before <= 8 * 2**20, (mem_before, mem_after)
    n_tok = sum(len(o) for o in outs)
    row = dict(model=name, n_layer=cfg.n_layer, warmup_s=warmup_s,
               **capture, requests=len(reqs),
               prompt_lens=prompt_lens, new_tokens=n_tok,
               gen_s=gen_s, tokens_per_s=n_tok / gen_s,
               eager_gen_s=eager_s, eager_tokens_per_s=n_tok / eager_s,
               flash_launches=launches, prefills=prefills,
               prefill_calls=prefill_calls, compiled_step_calls=calls,
               cache_before=stats0, cache_after=stats1,
               chunk_steps=m["chunk_steps"], decode_steps=m["decode_steps"],
               prefix_cache_hit_tokens=m["prefix_cache_hit_tokens"],
               first_logit_max_diff=worst, bucket_logit_diff=bucket_diff,
               compared_tokens=compared, near_ties=ties,
               observed=observed, leaked_pages=leaked,
               prefill_ms=graphed[0], decode_ms_b8=graphed[1],
               profiles=graphed[2], eager_prefill_ms=eager_times[0],
               eager_decode_ms_b8=eager_times[1],
               eager_profiles=eager_times[2],
               mem_before_mib=_mib(mem_before), mem_after_mib=_mib(mem_after),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"engine[{name}]: warm-up {warmup_s:.2f} s: {capture['graphs']} "
          f"graphs captured in {capture['capture_s']:.2f} s, holding "
          f"{capture['graph_mib']:.1f} MiB (static buffers and pool)")
    print(f"engine[{name}]: {len(reqs)} requests x {max_new} tokens in "
          f"{gen_s:.3f} s = {n_tok / gen_s:.1f} tok/s with graphs, "
          f"{n_tok / eager_s:.1f} tok/s eager; flash launches {launches} = "
          f"{cfg.n_layer} x {prefills} prefills (profiled prefill replay: "
          f"{top_profile['flash_fwd_per_step']:.0f}); chunk steps "
          f"{m['chunk_steps']}; cache hits {stats1['hits'] - stats0['hits']}"
          f" = compiled step calls, misses +0, retraces "
          f"{stats1['retraces']}; first-token logits max diff vs plain "
          f"{worst:.4f}; buckets vs eager max logit diff "
          f"{max(bucket_diff.values()):.4f}; tokens equal to the eager "
          f"engine's: {compared} compared, {len(ties)} near-tie stop(s) "
          f"{[(t['request'], t['token'], round(t['gap'], 4)) for t in ties]}"
          f"; leaked {leaked}")
    print(f"engine[{name}]: recorder {observed['records']} records, phase "
          f"sum/total {observed['phase_ratio'][0]:.4f}.."
          f"{observed['phase_ratio'][1]:.4f}, TTFT ms "
          f"{[round(x, 2) for x in observed['ttft_ms']]}; step profiler "
          f"{observed['step_records']} records, step ms p50 "
          f"{observed['step_ms_p50']:.3f} max {observed['step_ms_max']:.3f};"
          f" in the run a decode pass took "
          f"{observed['decode_ms_per_step']:.3f} ms and a prefill "
          f"{observed['prefill_ms_per_step']:.3f} ms; pump beats "
          f"{observed['pump_beats']}, stalls {observed['pump_stalls']}; "
          f"memory allocated {_mib(mem_before)} MiB before the engine, "
          f"{_mib(mem_after)} MiB after shutdown")
    for label, (p_ms, d_ms, profiles) in (("graphs", graphed),
                                          ("eager", eager_times)):
        print(f"engine[{name}]: {label}: prefill ms by bucket "
              f"{ {s: round(v, 3) for s, v in p_ms.items()} }; decode "
              f"{d_ms:.3f} ms/step at batch 8")
        for key, p in profiles.items():
            busy = "not measured" if p["busy_share"] is None else \
                f"{p['device_ms']:.3f} ms device busy = {p['busy_share']:.1%}"
            print(f"engine[{name}]: {label}: profile {key}: "
                  f"{p['wall_ms']:.3f} ms/step wall, {busy}, "
                  f"{p['kernels_per_step']:.0f} kernels/step ({_whole(p)}), "
                  f"flash "
                  f"{p['flash_ms']:.3f} ms; top {p['top'][:4]}")
    return row


SPEC_K = 4


def phase_engine_spec(cfg, buckets, prompt_lens, max_new, seed,
                      device="cuda"):
    """GPT-2 125M with speculative decoding (K = `SPEC_K`), once with a
    self-draft and once with an independent 2-layer draft (fresh weights
    from another seed), against the plain engine's greedy tokens on the
    same weights and prompts, every bucket a graph (the target's, the
    verify windows and the draft's). bf16 verify (a chunk step) and bf16
    decode may round a near tie apart: a token that differs passes only
    where the plain run's top-2 logit gap at that position is within
    LOGIT_ATOL, and that request's comparison stops there."""
    print(f"engine_spec: {cfg}, K={SPEC_K}")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = gpt_mod.init_params(cfg, gen, device=device)
    prompts = _prompts(cfg, prompt_lens, seed)
    ecfg = dict(batch_buckets=(1, 2, 4, 8), prefill_buckets=buckets)
    plain = _SmokeEngine(model="gpt", model_cfg=cfg, params=params,
                         device=device, engine_config=EngineConfig(**ecfg),
                         record_gaps=True)
    plain.warmup()
    reqs, want, plain_s, _ = _serve(plain, prompts, max_new)
    gaps = [plain.gaps[r.id] for r in reqs]
    assert plain.shutdown() == 0
    del plain
    n_tok = len(prompts) * max_new
    print(f"engine_spec: plain {n_tok} tokens in {plain_s:.3f} s = "
          f"{n_tok / plain_s:.1f} tok/s")
    rows = []
    for label, draft_cfg in (("self", None),
                             ("independent 2-layer",
                              dataclasses.replace(cfg, n_layer=2))):
        # draft_cfg alone: the engine draws the draft from seed + 1 of
        # its own seed, another seed than the target's
        eng = LLMEngine(model="gpt", model_cfg=cfg, params=params,
                        device=device, seed=seed + 10, draft_cfg=draft_cfg,
                        engine_config=EngineConfig(spec_k=SPEC_K, **ecfg))
        capture = _capture(eng)
        stats0 = cache_stats()
        reqs, outs, gen_s, launches = _serve(eng, prompts, max_new)
        stats1 = cache_stats()
        m = eng.metrics()
        calls = m["compiled_step_calls"]
        _check_cache(stats0, stats1, calls)
        prefills = sum(c for k, c in calls.items()
                       if k.startswith("prefill:"))
        d_prefills = sum(c for k, c in calls.items()
                         if k.startswith("draft_prefill:"))
        d_layers = eng.draft_cfg.n_layer
        assert d_prefills == len(prompts), calls  # every prompt fits
        assert launches == cfg.n_layer * prefills + d_layers * d_prefills, (
            launches, calls)
        compared, ties = _near_tie_compare(outs, want, gaps,
                                           f"engine_spec[{label}]")
        bucket_diff = _check_buckets(eng, seed)
        leaked = eng.shutdown()
        assert leaked == 0, f"{leaked} KV pages leaked"
        del eng
        accept = m["spec_accepted"] / m["spec_proposed"]
        if label == "self":
            # the draft is the target: only near ties reject
            assert accept > 0.5, m
        row = dict(draft=label, draft_layers=d_layers, k=SPEC_K,
                   requests=len(reqs), new_tokens=n_tok, gen_s=gen_s,
                   tokens_per_s=n_tok / gen_s, plain_tokens_per_s=n_tok
                   / plain_s, spec_rounds=m["spec_rounds"],
                   spec_proposed=m["spec_proposed"],
                   spec_accepted=m["spec_accepted"], acceptance=accept,
                   # decode tokens per lane and round (<= K + 1)
                   tokens_per_lane_round=(n_tok - len(reqs)) * SPEC_K
                   / m["spec_proposed"],
                   flash_launches=launches,
                   draft_prefill_launches=d_layers * d_prefills,
                   **capture, cache_before=stats0, cache_after=stats1,
                   bucket_logit_diff=bucket_diff,
                   compared_tokens=compared, near_tie_stops=len(ties),
                   near_ties=ties,
                   compiled_step_calls=calls, leaked_pages=leaked)
        rows.append(row)
        print(f"engine_spec[{label}]: {capture['graphs']} graphs captured "
              f"in {capture['capture_s']:.2f} s ({capture['graph_mib']:.1f}"
              f" MiB); {n_tok} tokens in {gen_s:.3f} s = "
              f"{n_tok / gen_s:.1f} tok/s (plain {n_tok / plain_s:.1f}); "
              f"{m['spec_rounds']} rounds, accepted {m['spec_accepted']} of "
              f"{m['spec_proposed']} proposals = {accept:.1%}; flash "
              f"launches {launches} (draft prefill {d_layers} x "
              f"{d_prefills}); cache hits {stats1['hits'] - stats0['hits']}"
              f" = compiled step calls, misses +0; buckets vs eager max "
              f"logit diff {max(bucket_diff.values()):.4f}; tokens equal to "
              f"plain greedy: {compared} compared, {len(ties)} request(s) "
              f"stopped at a near tie (request, token, gap): "
              f"{[(t['request'], t['token'], round(t['gap'], 4)) for t in ties]}")
    return rows


def _numbers(row):
    return {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}


FWD_DESIGN = (
    "bf16/fp16 (route sm90): one block per (Q tile, head, batch row): two "
    "consumer warpgroups (128 query rows) where the grid gives every SM "
    "two blocks, else one (64 rows), + one TMA producer warp; 2-stage K/V "
    "ring (64 keys, swizzled, mbarriers); S = QK^T wgmma m64n64k16 SS and "
    "O += PV wgmma RS (V MN-major), S/P/O in registers, exp2 softmax with "
    "quad shuffles; mask only on diagonal/ragged tiles; longest causal "
    "tiles first. f32 (route f32): CUDA-core FMAs through shared memory.")
BWD_DESIGN = (
    "bf16/fp16 (route sm90): two kernels, each output one owner block (no "
    "atomics, deterministic). dQ: a block per 64-row Q tile, K/V ring; "
    "S, dP wgmma SS, P/dS in registers, dQ += dS K wgmma RS (K MN-major). "
    "dK/dV: a block per 64-key tile, ring of Q/dO tiles (64 rows; 32 at "
    "head_dim 128) with lse/delta; S^T, dP^T wgmma SS, dV += P^T dO and "
    "dK += dS^T Q wgmma RS; one consumer warpgroup + one TMA producer "
    "warp each. Executes 14 D FLOPs per pair and head (S and dP in both "
    "kernels) against the 10 D bound. f32 (route f32): CUDA-core FMAs.")


def kernels_line(rows, bwd_rows, train, train_llama, train_long, gpt, llama,
                 spec, ptxas):
    """The `kernels` entries: every ported kernel with its numbers. The
    forward at the serving path's largest prefill shape (with the GPT-2
    run's launches per prefill bucket at that bucket's time), the
    backward at the GPT-2 training shape, and both at each training
    path's shape (`training_paths`). `launches` are
    the GPT-2 serving run's (forward) and the GPT-2 training run's
    (backward); `launches_*` the other main paths' (`engine_spec`: both
    spec runs, and of them the draft prefills)."""
    def at(table, shape):
        return next(r for r in table if r["shape"] == shape)

    main_row, bwd_row = at(rows, MAIN_SHAPE), at(bwd_rows, TRAIN_SHAPE)

    def per_path(table, key):
        # each training path's launches with the times at its shape
        return {name: dict(at=shape, launches=path[key],
                           **_numbers(at(table, shape)))
                for name, shape, path in (
                    ("train", TRAIN_SHAPE, train),
                    ("train_llama", TRAIN_LLAMA_SHAPE, train_llama),
                    ("train_long", TRAIN_LONG_SHAPE, train_long))}

    def graphed_launches(key):
        # the TrainStepRunner runs' launches (replays credited with their
        # capture's), e.g. launches_train_graph_k4
        return {f"launches_{path['phase']}_graph_{k}": g[key]
                for path in (train, train_llama, train_long)
                for k, g in path["graphed"].items()}

    # the GPT-2 run's launches per prefill bucket, at that bucket's time
    by_t = {r["t"]: r for r in rows if r["shape"].startswith("gpt2 prefill")}
    main_path = [dict(t=t, launches=gpt["n_layer"] * n, ms=by_t[t]["ms"],
                      bound_ms=by_t[t]["bound_ms"])
                 for t, n in sorted(gpt["prefill_calls"].items())]
    return [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:175 "
                    "(_fwd_single_kernel); ray_tpu/ops/flash_attention.py:"
                    "118 (_fwd_kernel)",
        "launches": gpt["flash_launches"],
        "launches_llama": llama["flash_launches"],
        "launches_train": train["fwd_launches"],
        "launches_train_llama": train_llama["fwd_launches"],
        "launches_train_long": train_long["fwd_launches"],
        **graphed_launches("fwd_launches"),
        "launches_engine_spec": sum(r["flash_launches"] for r in spec),
        "launches_engine_spec_draft_prefill": sum(
            r["draft_prefill_launches"] for r in spec),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **_numbers(main_row),
        "at": MAIN_SHAPE,
        "training_paths": per_path(rows, "fwd_launches"),
        "main_path": main_path,
        "main_path_kernel_ms": sum(r["launches"] * r["ms"]
                                   for r in main_path),
        "design": FWD_DESIGN,
        "ptxas": ptxas.get("flash_attention_fwd", []),
        "shapes": rows,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:192 "
                    "(_bwd_single_kernel); ray_tpu/ops/flash_attention.py:"
                    "288 (_dq_kernel); ray_tpu/ops/flash_attention.py:326 "
                    "(_dkv_kernel)",
        "launches": train["bwd_launches"],
        "launches_train_llama": train_llama["bwd_launches"],
        "launches_train_long": train_long["bwd_launches"],
        **graphed_launches("bwd_launches"),
        "kernels_per_call": BWD_KERNELS_PER_CALL,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "max_rel_err": max(max(r["rel_err"].values()) for r in bwd_rows),
        **_numbers(bwd_row),
        "at": TRAIN_SHAPE,
        "training_paths": per_path(bwd_rows, "bwd_launches"),
        "design": BWD_DESIGN,
        "ptxas": ptxas.get("flash_attention_bwd", []),
        "shapes": bwd_rows,
    }]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU",
              file=sys.stderr)
        return 1
    # the f32 kernel case is compared with a full-f32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    build_s, ptxas = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    bwd_rows = phase_backward(gen)
    train = phase_train(checkpoint=True)
    # bench.py's Llama run (`bench_llama_tokens_per_sec`): GQA 12:4
    train_llama = phase_train(
        "train_llama", "llama",
        cfg=llama_mod.LlamaConfig.llama_125m(remat=False, max_seq_len=1024))
    # bench.py's long-context run (`bench_gpt2_long_context`); the
    # full_attention comparison keeps [B, H, T, T] scores per layer, so it
    # runs at B=1
    train_long = phase_train("train_long", batch=4, seq=4096, grad_batch=1)

    gpt = phase_engine(
        "gpt", gpt_mod, gpt_mod.GPTConfig.gpt2_125m(), gpt_mod.GPT,
        buckets=GPT_BUCKETS, prompt_lens=GPT_PROMPT_LENS, max_new=32,
        seed=1)
    llama = phase_engine(
        "llama", llama_mod, llama_mod.LlamaConfig.llama_125m(),
        llama_mod.Llama,
        buckets=LLAMA_BUCKETS,
        prompt_lens=[9, 150, 69, 94, 1500], max_new=16, seed=2)
    # the GPT-2 engine phase's weights, prompts and lengths, speculating
    spec = phase_engine_spec(gpt_mod.GPTConfig.gpt2_125m(), GPT_BUCKETS,
                             GPT_PROMPT_LENS, max_new=32, seed=1)

    kernels = kernels_line(rows, bwd_rows, train, train_llama, train_long,
                           gpt, llama, spec, ptxas)
    print(json.dumps({"build_s": build_s, "train": train,
                      "train_llama": train_llama, "train_long": train_long,
                      "engines": [gpt, llama], "engine_spec": spec}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
