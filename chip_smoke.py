#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (`nvcc`) and this checkout; no
network, no JAX. Phases, each of which raises (and so ends the run with
a non-zero exit) on any failed check:

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: every CUDA kernel source of the port, compiled from the
   checkout (`ray_tpu_torch/ops/csrc/*.cu` with the shared
   `csrc/hopper.cuh`, one nvcc each, in parallel; the runtime's native
   store `ray_tpu_torch/native/shm_store.cc` with g++ beside them), with
   each kernel instance's registers, stack and spill bytes parsed from
   ptxas' log (`ops/build/<name>.log`) and its dynamic shared memory and
   blocks per SM from the CUDA runtime;
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
8. runtime: the port's own runtime (`ray_tpu_torch.init`): a node of its
   GCS, raylet and workers on a 2 GiB shared-memory store (/dev/shm's
   free space checked first), the card detected as its one `GPU`. A CPU
   task sees CUDA_VISIBLE_DEVICES="" and no CUDA; a num_gpus=1 task sees
   "0" and the card (its round trip is a GPU worker's start). A GPU
   worker runs `flash_attention_fwd` on q/k/v of the `train` shape from
   the store, against the plain version there, and its O equals the
   driver's call bit for bit; it loads the driver's build. GPT-2 125M's
   AdamW carry (592 tensors, 1.5 GB) goes through the store to a GPU
   worker, which returns each leaf's checksum on the card (equal to the
   driver's), and a 1 GiB CUDA tensor put in a GPU worker reaches the
   driver on the card (put and get GB/s beside the host's memcpy GB/s).
   A num_gpus=1 actor builds the GPT-2 engine of phase 6 (seed 1, every
   bucket a graph) and answers its 8 prompts as concurrent calls: the
   tokens equal phase 6's under the near-tie rule. While it lives a
   second GPU task stays unscheduled; after `kill` it runs. Prints the
   median round trip of a no-op CPU task and of an actor method over
   200 calls, and tok/s beside phase 6's. `shutdown()` must leave no
   process of the port's runtime and no /dev/shm/ray_tpu_torch_*
   segment;
9. serve: the port's Serve. `serve.run(serve.llm.build_app(name="llm",
   model="gpt", model_config=<GPT-2 125M>, seed=1, device="cuda"))` on a
   node of the port's runtime (the card its one `GPU`, a 1 GiB store):
   one num_gpus=1 replica holding the card, the engine of phase 6 (same
   seed, buckets, every bucket a graph). Its 8 prompts go through the
   `DeploymentHandle` as concurrent streams, 32 tokens each, once on the
   Python router path and once, on a second node with
   RAY_TPU_NATIVE_DISPATCH=1 for the driver and every worker, on the
   native request ring (built from `ray_tpu_torch/native/
   request_ring.cc`; its `stats()` must show the requests enqueued and
   drained). Checks on each: the tokens equal phase 6's under the
   near-tie rule, the forward kernel ran n_layer times per prefill in
   the replica (counts at 0 just before, read just after) and the
   backward never, one client record per request. On the ring's node
   the replica is killed while a stream runs: the card's free memory
   comes back to within the arena's bytes + 256 MiB of its value before
   the deployment, the controller reclaims the dead replica's arena
   record (`serve_llm_arenas_reclaimed_total` 1), the stream resumes on
   the replacement and equals the replacement's own answer, whose first
   32 tokens are phase 6's. The ring's domain segment is sized from the
   model's max_seq_len (its bytes checked against the layout's formula
   and printed). Prints the replica's time to come up, tok/s,
   TTFT and TPOT p50/p90 (request recorder), the replacement's first
   token after the kill. Each shutdown leaves no process, no
   /dev/shm/ray_tpu_torch_* segment (store, ring, FIFOs) and the card's
   memory back;
10. train_dist: the port's distributed train plane. On a node of the
   port's runtime (2 CPUs, the card its one `GPU`),
   `TorchTrainer(scaling_config=ScalingConfig(num_workers=1,
   use_gpu=True), backend_config=TorchConfig(distributed="on",
   platform="cuda"))` under its one-trial Tune run (the controller loop
   in a trial actor that imports no torch) trains phase 5's GPT-2 125M
   (same seed, weights and batch) in a GPU worker joined in an NCCL
   process group of one rank: each step's gradients and loss averaged by
   one all-reduce of a flat bucket inside the step, through
   `TrainStepRunner` at K=1 for 6 steps (the carry's array checkpoint
   goes with step 4's report, a gang-durable commit), then at K=4 for 2
   calls. The rank dies (`os._exit`) after step 6 on its first attempt:
   the controller catches the death, starts a new GPU worker, which
   restores the step-4 checkpoint into its live carry and finishes the
   14 steps. Checks: every reported loss within 1e-3 relative of phase
   5's K=1 loss at the same step; the restored carry's leaf checksums
   equal the checkpoint's; `resumed_from` 4; the kernels launched
   n_layer times per step in each attempt (the backward twice that);
   NCCL; no process and no /dev/shm segment left. Prints the node's and
   the worker's start, `fit()` to the first report, step ms at K=1 and
   K=4 beside phase 5's, the checkpoint's persist ms, the kill to the
   replacement's first report, the restore, launches and peak memory;
11. train_data: the `train` cell fed through Data. 512 rows of 1025
   int32 tokens (numpy, seed 3) and an `id` column in 32 blocks, split
   into `x` and `y` by a `map_batches` in tasks, go to a
   `TorchTrainer(datasets={"train": ds})` GPU worker (one, no process
   group) through `streaming_split(1)`'s coordinator actor; the worker
   trains phase 5's GPT-2 125M (same seed and weights) on
   `iter_batches(batch_size=16, drop_last=True, prefetch_batches=2)`,
   each numpy batch copied to pinned host memory and then to the card
   (`non_blocking`), through `TrainStepRunner` at K=1 for 4 steps, then
   K=4 for 7 calls (32 steps, one pass). Checks: every row consumed once;
   each loss within 1e-3 relative of an eager reference that the driver
   runs after `fit()` on the rows each step consumed (blocks arrive in
   completion order); one capture per K; n_layer forward and 2 n_layer
   backward launches a step; no process or segment left. Prints step ms
   at K=1 and K=4 beside phase 5's and the iterator wait a step;
12. dag: the compiled DAG. Three `torch_stage`s over GPT-2 125M (the
   forward, the last position's logits, the greedy ids) at B=8, T=1024,
   bf16, fused by `experimental_compile()` into one `compiled_step`: one
   CUDA graph (one miss, then replays), 12 forward launches an execute,
   the output against the eager chain (ids under the near-tie rule, the
   logits' max difference), two results held across executes distinct.
   Then on a node of the port's runtime a num_gpus=1 actor holding GPT-2
   125M (ids [8, 128] to the last logits, a CUDA tensor, and those to
   the greedy ids) and a CPU actor consuming the ids, compiled onto
   shared-memory channels, a `MultiOutputNode` returning [the consumer's
   ids, the logits]: the ids equal the in-process greedy ids, the logits
   arrive on the driver's card. Prints the fused execute against the
   eager chain, and the compiled execute's median round trip over 50
   against the lazy `execute()`'s;
13. soak: the port's soak in local mode (30 s budget, seed 3, the
   `ckpt_fail` and `data_stall` fault classes; its clock starts at the
   gang's first report and leaves out a restart's outage; its train loop
   on the CPU by design), with the
   assertions of `tests/test_soak.py::test_soak_smoke_local`: both faults
   fire and recover, every failure injected, resume accounting and ingest
   watermarks clean. Prints the start to the first report and each
   process's fired and expired faults. Then the same soak in cluster
   mode (a head with one CPU, one two-CPU worker node, the autoscaler
   over a `FakeMultiNodeProvider`, the `kill@raylet` fault class) with
   the same assertions: the kill fires in the worker node's raylet and
   recovers on a node the autoscaler launched;
14. cluster: the cluster tooling. A cluster of the port's runtime whose
   head declares {"CPU": 2} (no GPU), and an `Autoscaler` over a
   `FakeMultiNodeProvider` with one node type {"CPU": 2, "GPU": 1}
   (max_workers 1, idle timeout 5 s). `JobSubmissionClient.submit_job`
   runs a driver script (written to `smoke_cluster/`) that runs a
   two-step `workflow`: a CPU step makes phase 6's prompts (numpy, seed
   1), and a num_gpus=1 step builds GPT-2 125M from phase 6's seed on
   the card and serves them through `LLMEngine` with every bucket a CUDA
   graph, 32 new tokens each, counting the forward kernel's launches
   from 0 just before the requests; then `workflow.resume` of the same
   id. Checks: the job SUCCEEDED; the autoscaler launched exactly one
   `gpu` node, `list_nodes` showed it alive with its GPU during the job,
   and the GPU step ran there; the tokens equal phase 6's under the
   near-tie rule and the kernel ran n_layer times per prefill; the
   resume ran no task (`list_tasks` shows one finished task of each
   step) and returned the stored output; `timeline()` holds the GPU
   step's task; once idle past the timeout the node is terminated,
   shows dead, and the card's free memory comes back to within 256 MiB
   of its value before the phase; no process or segment is left.
   Prints the submit to the node's registration, the registration to
   the first token, the job's and the resume's seconds, idle to
   termination, and the card's free memory before, during and after;
15. operator: the operator surface, every verb a subprocess `python -m
   ray_tpu_torch ...`. `start --head` with no `--resources` (the head
   detects the card: `GPU 1.0`), a CPU-only node joined by the command
   line `autoscaler/gcp_tpu.bootstrap_script` writes (plus `--resources
   '{"CPU": 2}'`, its own state file), `status` (2 alive nodes). Then
   `client-server` and a `client://` driver in its own process: a 64 MiB
   CUDA tensor put and got back equal (the client server relays it on
   the host), an actor, and a num_gpus=1 task that runs
   `flash_attention_fwd` at GPT-2's prefill shape (B=1, T=1024, 12
   heads, d=64, bf16) against its plain version (the `kernels` phase's
   tolerance; one launch). Then `serve-deploy` of a YAML config with two
   applications: GPT-2 125M (phase 6's seed, buckets, every bucket a
   graph) on a num_gpus=1 replica and a plain deployment on /echo; a
   driver that joins by address streams phase 6's 8 prompts through
   `get_deployment_handle("llm")` (tokens equal phase 6's under the
   near-tie rule, n_layer forward launches per prefill in the replica,
   counted from 0 just before), then HTTP through the port's proxy: a
   POST to /echo (200, JSON) and an unknown route (404). Then
   `dashboard` in its own process: `/` and all 16 `/api/*` routes
   answer 200 and JSON (the node with its GPU, the replica ALIVE, its
   `kv_pages_total`, the 8 requests); `list actors`, `summary`,
   `memory`, `timeline`, `stack --json` (the GCS, both raylets and the
   CLI, none unreachable), `alerts`, `top` (the replica's KV pages) and
   `job submit --wait`; last `serve shutdown`, SIGTERM to the dashboard
   and the client server, `stop` for both nodes. Checks also: every verb
   exits 0, no process of the session or segment is left, and the card's
   free memory comes back to within 256 MiB. Prints the head's start,
   the join, the client's put, get and GPU task, the deploy to the
   first token, tok/s, each dashboard route's ms and each verb's s;
16. parallel: `parallel/` on the card. (a) On a node of the port's runtime
   (the visible cards its `GPU`s), a `TorchTrainer` gang of one GPU worker
   per visible card (one on one card), `TorchConfig` NCCL: each builds
   `ShardingStrategy` by `__graft_entry__._pick_strategy(n)`'s rule (1:
   every axis 1; 4: fsdp=2 tp=2), its mesh over the gang's process group,
   places phase 5's GPT-2 125M (same seed, weights and batch) by
   `param_shardings` and `shard_batch`, and trains it through the sharded
   step (`models.gpt.sharded_loss`: the flash kernels on the rank's local
   heads, the fused CE vocab-parallel over tp, `reduce_gradients`, AdamW
   on the shards) under `TrainStepRunner(mesh=)`: K=1 for 6 steps, then
   K=4 twice, each K one captured graph. Checks: every loss within 1e-3
   relative of phase 5's K=1 loss at the same step (5e-3 for a step split
   over more than one card: bf16 partial sums in another order;
   `tools/parallel_cards.py` runs (a) alone on four); n_layer forward and
   2 n_layer backward launches a step in the rank; one miss per K, then
   hits; the backend and the mesh. Prints step ms beside phase 5's, the
   miss's seconds, the graph pool, peak memory, launches per step per
   rank. (b) Two processes on the one card in one gloo group (NCCL
   refuses two ranks on one device; `tools/gloo_cuda_probe.py` showed
   gloo runs the step's collectives on CUDA tensors), at tp=2 (the
   kernels on 6 heads a rank) and at fsdp=2: 3 eager steps each (gloo
   cannot be captured), each loss within 5e-3 relative of (a)'s, both
   ranks' losses equal, the launches counted in each rank;
17. the `kernels` JSON line (every ported kernel with its numbers), the
   card line, and last the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import threading
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch import native, serve
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import get_core_worker
from ray_tpu_torch._private.worker_api import ActorMethod
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
from ray_tpu_torch.serve import dispatch
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


def _timed(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


# the native sources (g++): the runtime's store, Serve's request ring
NATIVE_SOURCES = ("shm_store", "request_ring")


def phase_build():
    """Builds every source; returns (seconds, {source: [instance, ...]})
    with ptxas' numbers and the runtime's dynamic shared memory and
    blocks per SM for each kernel instance."""
    t0 = time.perf_counter()
    # the runtime's native store and Serve's request ring (g++) beside
    # the kernels (nvcc)
    native_s = {}
    builders = [threading.Thread(target=lambda name=name: native_s.update(
        {name: _timed(native.build, name)}))
        for name in NATIVE_SOURCES]
    for t in builders:
        t.start()
    seconds = _build.build()
    for t in builders:
        t.join()
    wall = time.perf_counter() - t0
    missing = [name for name in NATIVE_SOURCES if name not in native_s]
    assert not missing, f"the native sources {missing} did not build"
    print(f"build: {len(seconds)} source(s) compiled in {wall:.1f} s "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }; native "
          + "; ".join(f"{native.library_path(name)} in "
                      f"{native_s[name]:.1f} s" for name in NATIVE_SOURCES))
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
    eager_gaps = [eager.gaps[r.id] for r in eager_reqs]
    compared, ties = _near_tie_compare(outs, want, eager_gaps,
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
               tokens=outs,
               gaps=eager_gaps,
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


# -- the runtime: the port's own cluster, with the card as a GPU resource ----

RUNTIME_STORE_BYTES = 2 << 30      # the node's shared-memory store
RUNTIME_QKV = (16, 1024, 12, 64)   # the `train` shape: B, T, H, D (bf16)
RUNTIME_CUDA_PUT_BYTES = 1 << 30   # one CUDA tensor put from a GPU worker
RUNTIME_RTT_CALLS = 200            # round trips timed per kind
RUNTIME_MAX_NEW = 32
SERVE_MAX_NEW = 32


def _checksum(t):
    """An exact checksum of a tensor's bytes, the same on any device: the
    sum of its words and of each word times its 1-based index, in int64
    (wrapping alike everywhere)."""
    flat = t.detach().reshape(-1)
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[flat.element_size()]
    w = flat.view(word).to(torch.int64)
    idx = torch.arange(1, w.numel() + 1, device=w.device, dtype=torch.int64)
    return [int(w.sum()), int((w * idx).sum())]


def _port_processes(marks=(b"ray_tpu_torch._private.",)):
    """Live processes of the port's runtime on this machine (GCS, raylet,
    workers: `-m ray_tpu_torch._private.*`), or those whose command line
    holds one of `marks`, this one and zombies excluded."""
    live = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{entry}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and any(m in cmd for m in marks):
            live.append(int(entry))
    return live


def _assert_clean():
    """After a shutdown: no process of the port's runtime and no
    /dev/shm/ray_tpu_torch_* segment (stores, rings, compiled-DAG
    channels, FIFOs) is left, waiting up to 30 s for them to go."""
    deadline = time.monotonic() + 30
    while (_port_processes() or glob.glob("/dev/shm/ray_tpu_torch_*")) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _port_processes()
    segments = glob.glob("/dev/shm/ray_tpu_torch_*")
    assert not left and not segments, (left, segments)


@ray_tpu_torch.remote
def _rt_noop():
    return None


@ray_tpu_torch.remote
def _rt_cpu_probe():
    import torch
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.is_available(), torch.cuda.device_count())


@ray_tpu_torch.remote(num_gpus=1)
def _rt_gpu_probe(device):
    import torch
    name = None
    if device == "cuda":
        torch.zeros(1, device="cuda")  # the CUDA context
        name = torch.cuda.get_device_name(0)
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.is_available(), torch.cuda.device_count(), name,
            os.getpid())


@ray_tpu_torch.remote(num_gpus=1)
def _rt_flash_task(q, k, v, device):
    """The forward kernel in a GPU worker on q/k/v from the store, held
    against its plain version there; the launch count is 0 just before
    the call and read just after it."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)
    t0 = time.perf_counter()
    if device == "cuda":
        _build.load("flash_attention_fwd")  # the driver's build, no nvcc
    load_s = time.perf_counter() - t0
    q, k, v = (x.to(device) for x in (q, k, v))
    with torch.inference_mode():
        flash_attention.launches = 0
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        launches = flash_attention.launches
        ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    return out.cpu(), launches, err, lse_err, load_s, os.getpid()


@ray_tpu_torch.remote(num_gpus=1)
def _rt_carry_task(refs, device):
    """Gets the carry (refs[0]) from the store, moves it to the card and
    returns each leaf's checksum there, with the seconds each part took:
    the get, the first copy to the card (this process's first touch of
    the store's pages) and a second copy of the same views."""
    t0 = time.perf_counter()
    carry = ray_tpu_torch.get(refs[0])
    get_s = time.perf_counter() - t0
    leaves = _tensor_leaves(carry)
    to_device_s = []
    for _ in range(2):
        t1 = time.perf_counter()
        moved = [x.to(device) for x in leaves]
        if device == "cuda":
            torch.cuda.synchronize()
        to_device_s.append(time.perf_counter() - t1)
    return ([_checksum(x) for x in moved], get_s, to_device_s,
            sum(x.nbytes for x in leaves), moved[0].device.type)


@ray_tpu_torch.remote(num_gpus=1)
def _rt_cuda_put_task(nbytes, seed, device):
    """Puts one `nbytes` tensor that lives on the card; returns its ref
    (in a list, so the caller's get times the fetch), its checksum and
    the put's seconds."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(nbytes // 4, generator=gen, device=device)
    sums = _checksum(t)
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(t)
    put_s = time.perf_counter() - t0
    return [ref], sums, put_s, t.device.type


@ray_tpu_torch.remote(num_gpus=1, max_concurrency=16)
class _EngineActor:
    """GPT-2 with random weights from `seed` (as the `gpt` engine phase
    builds it) served from a GPU actor: every bucket a CUDA graph
    captured at `warmup()`, the pump thread started; `generate` is one
    request, answered while other calls run concurrently."""

    def __init__(self, cfg, seed, buckets, device):
        from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
        gen = torch.Generator(device=device).manual_seed(seed)
        params = gpt_mod.init_params(cfg, gen, device=device)
        t0 = time.perf_counter()
        self.eng = LLMEngine(
            model="gpt", model_cfg=cfg, params=params, device=device,
            engine_config=EngineConfig(batch_buckets=(1, 2, 4, 8),
                                       prefill_buckets=buckets))
        self.eng.warmup()
        self.warmup_s = time.perf_counter() - t0
        self.eng.start()

    def info(self):
        return dict(warmup_s=self.warmup_s, pid=os.getpid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))

    def reset_counts(self):
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0

    def counts(self):
        return flash_attention.launches, flash_attention_bwd.launches

    def generate(self, prompt, max_new):
        return self.eng.submit(prompt, max_new).result(timeout=600)

    def ping(self):
        return None


def _runtime_carry(device):
    """GPT-2 125M's AdamW carry as the `train` phase builds it (f32 master
    weights, moments, step counts; seed 3), after one AdamW step at B=2,
    T=128 so the moments are not zero."""
    cfg = gpt_mod.GPTConfig.gpt2_125m(remat=False)
    model, inputs, targets = _train_setup("gpt", cfg, 3, 2, 128,
                                          flash_attention, device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4,
                            capturable=torch.device(device).type == "cuda")
    carry = _adamw_carry(model, opt)
    _loss(model, inputs, targets).backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return {key: {n: x.detach() for n, x in part.items()}
            for key, part in carry.items()}


def _memcpy_gbps(leaves):
    """Host memcpy GB/s of the same bytes (a single-thread `np.copyto` of
    each leaf into a buffer of its own, best of 3; bench.py's ceiling)."""
    src = [x.reshape(-1).view(torch.uint8).numpy() for x in leaves]
    dst = [np.empty_like(a) for a in src]
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for d, s in zip(dst, src):
            np.copyto(d, s)
        best = min(best, time.perf_counter() - t0)
    return sum(a.nbytes for a in src) / best / 1e9


def _median_rtt_ms(call, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_runtime(gpt, engine_cfg=None, buckets=GPT_BUCKETS,
                  prompt_lens=GPT_PROMPT_LENS, carry_fn=_runtime_carry,
                  qkv=RUNTIME_QKV, cuda_put_bytes=RUNTIME_CUDA_PUT_BYTES,
                  store_bytes=RUNTIME_STORE_BYTES, device="cuda"):
    """The port's runtime on the card (module docstring, phase 8): a node
    of the port's own GCS, raylet and workers, the card detected as its
    one `GPU`; the forward kernel in a GPU worker; the train carry and a
    CUDA tensor through the store; the `gpt` phase's engine served from
    a GPU actor; round trips; a clean shutdown. `gpt` is that phase's
    row (its tokens, the eager run's top-2 gaps, tok/s)."""
    card = card_line() if device == "cuda" else "cpu"
    engine_cfg = engine_cfg or gpt_mod.GPTConfig.gpt2_125m()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # a store larger than /dev/shm fails with SIGBUS, not an error
    shm_free = shutil.disk_usage("/dev/shm").free
    if shm_free < store_bytes:
        raise RuntimeError(
            f"runtime: /dev/shm has {shm_free} bytes free, under the store's "
            f"{store_bytes}")
    assert not _port_processes(), _port_processes()
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=store_bytes,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    init_s = time.perf_counter() - t0
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        want_gpus = torch.cuda.device_count() if device == "cuda" else 1
        assert gpus == want_gpus == 1, (gpus, want_gpus)

        # isolation; the first GPU task's round trip is a worker's start
        cpu_visible, cpu_cuda, cpu_count = ray_tpu_torch.get(
            _rt_cpu_probe.remote(), timeout=300)
        assert cpu_visible == "" and not cpu_cuda and cpu_count == 0, (
            cpu_visible, cpu_cuda, cpu_count)
        t0 = time.perf_counter()
        visible, has_cuda, n_dev, name, gpu_pid = ray_tpu_torch.get(
            _rt_gpu_probe.remote(device), timeout=300)
        gpu_start_s = time.perf_counter() - t0
        assert visible == "0", visible
        if device == "cuda":
            assert has_cuda and n_dev == 1, (has_cuda, n_dev)
            assert name == torch.cuda.get_device_name(0), name
        print(f"runtime: node up in {init_s:.2f} s, GPU {gpus:.0f} detected "
              f"(torch sees {want_gpus}); a CPU task sees "
              f"CUDA_VISIBLE_DEVICES={cpu_visible!r}, cuda available "
              f"{cpu_cuda}; a num_gpus=1 task sees {visible!r}, {name}; GPU "
              f"worker start (spawn, torch import, CUDA context, to the first"
              f" result) {gpu_start_s:.2f} s (card: {card})")

        # the forward kernel in the worker, on tensors from the store
        gen = torch.Generator().manual_seed(5)
        b, t, h, d = qkv
        q, k, v = (torch.randn(b, t, h, d, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        refs = [ray_tpu_torch.put(x) for x in (q, k, v)]
        out, w_launches, err, lse_err, load_s, flash_pid = ray_tpu_torch.get(
            _rt_flash_task.remote(*refs, device), timeout=300)
        tol_o, tol_lse = TOL[torch.bfloat16]
        assert err <= tol_o and lse_err <= tol_lse, (err, lse_err)
        with torch.inference_mode():
            mine = flash_attention(*(x.to(device) for x in (q, k, v)),
                                   causal=True).cpu()
        assert out.dtype == mine.dtype and torch.equal(out, mine), \
            "the worker's kernel output differs from the driver's"
        if device == "cuda":
            assert w_launches == 1, w_launches
        del refs, out, mine
        print(f"runtime: flash_attention_fwd in a GPU worker (pid "
              f"{flash_pid}) on q/k/v {list(qkv)} bf16 from the store: "
              f"{w_launches} launch(es), O err {err:.2e} lse err "
              f"{lse_err:.2e} vs plain (tol {tol_o}/{tol_lse}), O equal to "
              f"the driver's call bit for bit; kernel library load "
              f"{load_s:.3f} s (the driver's build, no nvcc)")

        # state at its real size: the carry through the store to the card
        carry = carry_fn(device)
        leaves = _tensor_leaves(carry)
        sums = [_checksum(x) for x in leaves]
        host = {key: {n: x.cpu() for n, x in part.items()}
                for key, part in carry.items()}
        del carry, leaves
        host_leaves = _tensor_leaves(host)
        nbytes = sum(x.nbytes for x in host_leaves)
        memcpy_gbps = _memcpy_gbps(host_leaves)
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(host)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_sums, get_s, to_dev_s, got_bytes, where = ray_tpu_torch.get(
            _rt_carry_task.remote([ref], device), timeout=600)
        carry_task_s = time.perf_counter() - t0
        assert where == torch.device(device).type, where
        assert got_bytes == nbytes and got_sums == sums, (
            "carry checksums differ",
            [i for i, (a, c) in enumerate(zip(got_sums, sums)) if a != c])
        # the same put again, once the first object is freed: the store
        # places it in the pages this process has written before
        del ref
        gc.collect()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(host)
        put_again_s = time.perf_counter() - t0
        del ref, host, host_leaves
        carry_row = dict(leaves=len(sums), bytes=nbytes, put_s=put_s,
                         put_gbps=nbytes / put_s / 1e9,
                         put_again_s=put_again_s,
                         put_again_gbps=nbytes / put_again_s / 1e9,
                         get_s=get_s, get_gbps=nbytes / get_s / 1e9,
                         to_device_s=to_dev_s,
                         to_device_gbps=[nbytes / x / 1e9 for x in to_dev_s],
                         task_s=carry_task_s, memcpy_gbps=memcpy_gbps)
        print(f"runtime: AdamW carry, {len(sums)} tensors, {nbytes / 1e9:.3f}"
              f" GB: put {put_s:.3f} s = {carry_row['put_gbps']:.2f} GB/s "
              f"(again, into pages written before: {put_again_s:.3f} s = "
              f"{carry_row['put_again_gbps']:.2f} GB/s), get in a GPU worker"
              f" {get_s:.4f} s = {carry_row['get_gbps']:.1f} GB/s (views "
              f"over the store), to the card {to_dev_s[0]:.3f} s = "
              f"{carry_row['to_device_gbps'][0]:.2f} GB/s (again from the "
              f"same views: {to_dev_s[1]:.3f} s = "
              f"{carry_row['to_device_gbps'][1]:.2f} GB/s); host memcpy of "
              f"the same bytes {memcpy_gbps:.2f} GB/s; every leaf's checksum"
              f" on the card equals the driver's (card: {card})")

        # one CUDA tensor put in a GPU worker, fetched by the driver
        (tref,), t_sums, t_put_s, t_where = ray_tpu_torch.get(
            _rt_cuda_put_task.remote(cuda_put_bytes, 7, device), timeout=300)
        t0 = time.perf_counter()
        fetched = ray_tpu_torch.get(tref, timeout=300)
        if device == "cuda":
            torch.cuda.synchronize()
        t_get_s = time.perf_counter() - t0
        assert t_where == fetched.device.type == torch.device(device).type, \
            (t_where, fetched.device)
        assert fetched.nbytes == cuda_put_bytes and \
            _checksum(fetched) == t_sums
        del tref, fetched
        cuda_row = dict(bytes=cuda_put_bytes, put_s=t_put_s,
                        put_gbps=cuda_put_bytes / t_put_s / 1e9,
                        get_s=t_get_s,
                        get_gbps=cuda_put_bytes / t_get_s / 1e9)
        print(f"runtime: a {cuda_put_bytes / 2**30:.0f} GiB CUDA tensor put "
              f"in a GPU worker {t_put_s:.3f} s = {cuda_row['put_gbps']:.2f}"
              f" GB/s (card to host to store), fetched by the driver onto "
              f"{t_where} in {t_get_s:.3f} s = {cuda_row['get_gbps']:.2f} "
              f"GB/s, checksum equal (card: {card})")

        # the GPT-2 engine served from a GPU actor
        t0 = time.perf_counter()
        actor = _EngineActor.remote(engine_cfg, 1, buckets, device)
        info = ray_tpu_torch.get(actor.info.remote(), timeout=600)
        actor_up_s = time.perf_counter() - t0
        assert info["visible"] == "0", info
        prompts = _prompts(engine_cfg, prompt_lens, 1)
        ray_tpu_torch.get(actor.reset_counts.remote(), timeout=60)
        t0 = time.perf_counter()
        outs = ray_tpu_torch.get(
            [actor.generate.remote(p, RUNTIME_MAX_NEW) for p in prompts],
            timeout=600)
        gen_s = time.perf_counter() - t0
        a_fwd, a_bwd = ray_tpu_torch.get(actor.counts.remote(), timeout=60)
        assert a_bwd == 0, a_bwd
        if device == "cuda":
            # one prefill per prompt, or a chunk step (no kernel) for a
            # prompt that found its shared prefix cached
            assert 0 < a_fwd <= engine_cfg.n_layer * len(prompts), a_fwd
            assert a_fwd % engine_cfg.n_layer == 0, a_fwd
        assert all(len(o) == RUNTIME_MAX_NEW for o in outs)
        compared, ties = _near_tie_compare(outs, gpt["tokens"], gpt["gaps"],
                                           "runtime actor")
        n_tok = len(prompts) * RUNTIME_MAX_NEW
        actor_rtt_ms = _median_rtt_ms(
            lambda: ray_tpu_torch.get(actor.ping.remote(), timeout=60),
            RUNTIME_RTT_CALLS)
        task_rtt_ms = _median_rtt_ms(
            lambda: ray_tpu_torch.get(_rt_noop.remote(), timeout=60),
            RUNTIME_RTT_CALLS)
        print(f"runtime: GPT-2 engine in a num_gpus=1 actor (pid "
              f"{info['pid']}, CUDA_VISIBLE_DEVICES={info['visible']!r}) up "
              f"in {actor_up_s:.2f} s (warm-up {info['warmup_s']:.2f} s); "
              f"{len(prompts)} requests x {RUNTIME_MAX_NEW} tokens as "
              f"concurrent calls in {gen_s:.3f} s = {n_tok / gen_s:.1f} tok/s"
              f" (in-process `gpt` phase: {gpt['tokens_per_s']:.1f} tok/s); "
              f"flash launches {a_fwd}; tokens equal to the `gpt` phase's: "
              f"{compared} compared, {len(ties)} near-tie stop(s); median "
              f"round trip over {RUNTIME_RTT_CALLS}: no-op CPU task "
              f"{task_rtt_ms:.3f} ms, actor method {actor_rtt_ms:.3f} ms "
              f"(card: {card})")

        # the actor holds the GPU: another GPU task waits until the kill
        waiting = _rt_gpu_probe.remote(device)
        ready, _ = ray_tpu_torch.wait([waiting], timeout=2)
        assert ready == [], "a GPU task ran while the actor held the GPU"
        ray_tpu_torch.kill(actor)
        t0 = time.perf_counter()
        after_visible = ray_tpu_torch.get(waiting, timeout=300)[0]
        after_kill_s = time.perf_counter() - t0
        assert after_visible == "0", after_visible
        print(f"runtime: a second num_gpus=1 task stayed unscheduled while "
              f"the actor lived (wait 2 s: not ready) and ran "
              f"{after_kill_s:.2f} s after kill(actor)")
        live = _port_processes()
        assert live, "no runtime process found before shutdown"
    finally:
        ray_tpu_torch.shutdown()
    _assert_clean()
    print(f"runtime: shutdown left no process of the port's session "
          f"({len(live)} were up) and no /dev/shm/ray_tpu_torch_* segment")
    return dict(
        init_s=init_s, gpus=gpus, shm_free_bytes=shm_free,
        store_bytes=store_bytes, cpu_task_visible=cpu_visible,
        gpu_task_visible=visible, gpu_worker_start_s=gpu_start_s,
        flash=dict(qkv=list(qkv), launches=w_launches, max_abs_err=err,
                   lse_err=lse_err, library_load_s=load_s,
                   bit_equal_to_driver=True),
        carry=carry_row, cuda_tensor=cuda_row,
        actor=dict(up_s=actor_up_s, warmup_s=info["warmup_s"],
                   requests=len(prompts), new_tokens=n_tok, gen_s=gen_s,
                   tokens_per_s=n_tok / gen_s,
                   in_process_tokens_per_s=gpt["tokens_per_s"],
                   flash_launches=a_fwd, compared_tokens=compared,
                   near_ties=ties),
        launches=w_launches + a_fwd,
        task_rtt_ms=task_rtt_ms, actor_rtt_ms=actor_rtt_ms,
        second_task_after_kill_s=after_kill_s, processes_at_end=len(live))


SERVE_STORE_BYTES = 1 << 30       # the node's shared-memory store
SERVE_MEM_SLACK = 256 << 20       # the card's free memory may stay under
SERVE_KILL_MAX_NEW = 256          # the stream the kill lands in
SERVE_KILL_AFTER = 4              # tokens delivered before the kill


def _model_config(cfg):
    """A model config as the plain dict a deployment takes (dtypes by
    name)."""
    return {f.name: (str(v).replace("torch.", "")
                     if isinstance(v, torch.dtype) else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


def _consume(gen, out, stamps, failover, arrived=None, n=0):
    """Reads a streaming response to its end on the calling thread: the
    tokens into `out`, each one's monotonic arrival time into `stamps`
    and whether the stream had failed over by then into `failover`;
    sets `arrived` once `n` tokens are in."""
    for chunk in gen:
        out.append(chunk["token"])
        stamps.append(time.monotonic())
        failover.append(bool(getattr(gen, "_failed_over", False)))
        if arrived is not None and len(out) >= n:
            arrived.set()


def _serve_streams(handle, prompts, max_new):
    """The prompts as concurrent `generate` streams through the handle,
    submitted at once and each read on a thread of its own; returns (the
    tokens, seconds, the stream types)."""
    outs = [[] for _ in prompts]
    errors = []
    t0 = time.perf_counter()
    gens = [handle.generate.options(stream=True).remote(p, max_new)
            for p in prompts]

    def read(i):
        try:
            _consume(gens[i], outs[i], [], [])
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=read, args=(i,))
               for i in range(len(gens))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    gen_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a stream never ended"
    return outs, gen_s, sorted({type(g).__name__ for g in gens})


def _pcts(values):
    return ([float(np.percentile(values, q)) for q in (50, 90)]
            if values else [None, None])


def _client_records(name):
    return [r for r in request_recorder.ring().recent()
            if r.role == "client" and r.deployment == name]


def _serve_ring(name):
    """The deployment's native segment, once its replica attached it."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            ring = dispatch.DispatchRing(dispatch.domain_segment(name),
                                         create=False)
        except FileNotFoundError:
            time.sleep(0.05)
            continue
        if ring.mode() == dispatch.MODE_RAW_LLM:
            return ring
        ring.close()
        time.sleep(0.05)
    raise AssertionError(f"serve: no replica attached the ring of {name!r}")


def _free_card_bytes(device):
    return torch.cuda.mem_get_info()[0] if device == "cuda" else 0


def _wait_free(device, floor, timeout):
    """Polls the card's free memory until it reaches `floor`; returns
    (the most seen, seconds)."""
    t0 = time.monotonic()
    best = _free_card_bytes(device)
    while best < floor and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
        best = max(best, _free_card_bytes(device))
    return best, time.monotonic() - t0


def _serve_kill(handle, prompt, gpt_tokens, gpt_gaps, free0, device):
    """Kills the replica while a stream runs on the Python path: the
    memory it held comes back to the card, the controller reclaims its
    arena and counts it, and the stream resumes on the replacement,
    which answers the prompt again with the same tokens."""
    ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    ray_tpu_torch.get(ctrl.reconcile_now.remote(), timeout=120)
    (replica,) = ray_tpu_torch.get(ctrl.get_replicas.remote("llm"),
                                   timeout=60)["replicas"]
    arena = ray_tpu_torch.get(replica.get_metrics.remote(),
                              timeout=60)["kv_arena_id"]
    store = get_core_worker().store
    oid = ObjectID.from_hex(arena)
    buf = store.get_buffer(oid, timeout=0)
    # on the card the store holds the arena's record; on the CPU the
    # arena itself
    record = json.loads(bytes(buf)) if device == "cuda" else dict(
        device="cpu", nbytes=buf.nbytes)
    del buf
    store.release(oid)
    assert record["device"].startswith(device) and record["nbytes"] > 0, \
        record
    tokens, stamps, failover = [], [], []
    arrived = threading.Event()
    errors = []
    gen = handle.generate.options(stream=True).remote(prompt,
                                                      SERVE_KILL_MAX_NEW)
    assert type(gen).__name__ == "DeploymentResponseGenerator"

    def read():
        try:
            _consume(gen, tokens, stamps, failover, arrived,
                     SERVE_KILL_AFTER)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    reader = threading.Thread(target=read)
    reader.start()
    assert arrived.wait(300), "serve: the stream did not start"
    ray_tpu_torch.kill(replica)
    t_kill = time.monotonic()
    killed_at = len(tokens)
    # the dead process's device memory (weights, arena, graphs) returns
    floor = free0 - record["nbytes"] - SERVE_MEM_SLACK
    free_after, free_s = _wait_free(device, floor, 60)
    if device == "cuda":
        assert free_after >= floor, (
            f"serve: the card's free memory came back to {free_after} "
            f"bytes, under {floor} (before the deployment {free0}, arena "
            f"{record['nbytes']})")
    deadline = time.monotonic() + 120
    while arena not in ray_tpu_torch.get(ctrl.get_reclaimed_arenas.remote(),
                                         timeout=60):
        assert time.monotonic() < deadline, "serve: the arena was not " \
            "reclaimed"
        ray_tpu_torch.get(ctrl.reconcile_now.remote(), timeout=120)
        time.sleep(0.2)
    text = ray_tpu_torch.get(ActorMethod(ctrl, "_metrics_text").remote(),
                             timeout=60)
    reclaimed_total = next(int(ln.split()[1]) for ln in text.splitlines()
                           if ln.startswith(
                               "serve_llm_arenas_reclaimed_total "))
    assert reclaimed_total == 1, text
    assert not store.contains(oid), "serve: the arena record is still there"
    reader.join(timeout=600)
    if errors:
        raise errors[0]
    assert not reader.is_alive(), "serve: the resumed stream never ended"
    assert len(tokens) == SERVE_KILL_MAX_NEW and any(failover), (
        len(tokens), killed_at, "the kill did not land mid-stream")
    first_new = next(t for t, f in zip(stamps, failover) if f)
    rerun = handle.generate_once.remote(prompt, SERVE_KILL_MAX_NEW).result(
        timeout=600)
    assert rerun == tokens, "serve: the resumed stream differs from the " \
        "replacement's answer"
    compared, ties = _near_tie_compare([rerun[:len(gpt_tokens)]],
                                       [gpt_tokens], [gpt_gaps],
                                       "serve replacement")
    (fo,) = [r for r in _client_records("llm")
             if r.outcome == "failed_over"]
    return dict(arena_id=arena, arena_record=record,
                reclaimed=ray_tpu_torch.get(
                    ctrl.get_reclaimed_arenas.remote(), timeout=60),
                reclaimed_total=reclaimed_total,
                killed_after_tokens=killed_at,
                replacement_first_token_s=first_new - t_kill,
                replayed_tokens=fo.replayed_tokens,
                free_before_deploy=free0, free_after_kill=free_after,
                free_after_kill_s=free_s, free_floor=floor,
                compared_tokens=compared, near_ties=ties)


def _serve_cluster(path, gpt, cfg, buckets, prompts, store_bytes, free0,
                   device):
    """One node of the port's runtime, the GPT-2 deployment on it, the
    prompts through the handle (RAY_TPU_NATIVE_DISPATCH=1 in the driver's
    and every worker's environment for `path="ring"`); on the ring
    cluster also the kill of the replica; then a clean shutdown."""
    card = card_line() if device == "cuda" else "cpu"
    ring_path = path == "ring"
    if ring_path:
        os.environ[dispatch.ENV_FLAG] = "1"
        native.load_request_ring()  # a ring that does not build fails
        assert dispatch.native_available()
    else:
        os.environ.pop(dispatch.ENV_FLAG, None)
    ray_tpu_torch.init(num_cpus=4, object_store_memory=store_bytes,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    try:
        t0 = time.perf_counter()
        handle = serve.run(serve.llm.build_app(
            name="llm", model="gpt", model_config=_model_config(cfg),
            engine_config=dict(batch_buckets=(1, 2, 4, 8),
                               prefill_buckets=buckets),
            seed=1, device=device,
            # the CPU rehearsal's faked GPU, as `cuda` asks by default
            **({} if device == "cuda" else
               {"ray_actor_options": {"num_gpus": 1}})))
        run_s = time.perf_counter() - t0  # the controller, the deploy
        m0 = handle.engine_metrics.remote().result(timeout=900)
        up_s = time.perf_counter() - t0
        assert ray_tpu_torch.available_resources().get("GPU", 0) == 0, \
            "serve: the replica does not hold the GPU"
        ring = _serve_ring("llm") if ring_path else None
        stats0 = ring.stats() if ring_path else None
        domain_bytes = None
        if ring_path:
            # the domain's request slots are sized from the model's
            # max_seq_len at deploy time
            domain_bytes = os.stat(
                "/dev/shm" + dispatch.domain_segment("llm")).st_size
            want = dispatch.domain_bytes(
                ring.table_cap, dispatch.ring_slots(),
                dispatch.request_slot_bytes(cfg.max_seq_len))
            assert domain_bytes == want, (domain_bytes, want)
        request_recorder.clear()
        # the main path: counts at 0 just before, read just after
        handle.kernel_launches.remote(reset=True).result(timeout=60)
        outs, gen_s, kinds = _serve_streams(handle, prompts, SERVE_MAX_NEW)
        launches = handle.kernel_launches.remote().result(timeout=60)
        m1 = handle.engine_metrics.remote().result(timeout=60)
        fwd, bwd = (launches["flash_attention"],
                    launches["flash_attention_bwd"])
        want_kind = ("NativeDeploymentResponseGenerator" if ring_path
                     else "DeploymentResponseGenerator")
        assert kinds == [want_kind], kinds
        assert all(len(o) == SERVE_MAX_NEW for o in outs)
        compared, ties = _near_tie_compare(outs, gpt["tokens"], gpt["gaps"],
                                           f"serve[{path}]")
        prefills = sum(
            c - m0["compiled_step_calls"].get(k, 0)
            for k, c in m1["compiled_step_calls"].items()
            if k.startswith("prefill:"))
        assert bwd == 0, bwd
        if device == "cuda":
            assert fwd == cfg.n_layer * prefills > 0, (fwd, prefills)
        ring_row = None
        if ring_path:
            s = ring.stats()
            ring_row = {k: s[k] - stats0[k] for k in s}
            assert ring_row["enqueued"] >= len(prompts) and \
                ring_row["drained"] >= len(prompts), ring_row
            ring.close()
        # one client record per stream (the unary control calls above
        # leave records without tokens)
        recs = [r for r in _client_records("llm") if r.tokens_out]
        assert len(recs) == len(prompts) and all(
            r.tokens_out == SERVE_MAX_NEW and r.outcome == "ok"
            for r in recs), [(r.tokens_out, r.outcome) for r in recs]
        ttft = _pcts([r.ttft_ms for r in recs if r.ttft_ms is not None])
        tpot = _pcts([r.tpot_ms for r in recs if r.tpot_ms is not None])
        n_tok = len(prompts) * SERVE_MAX_NEW
        row = dict(up_s=up_s, run_s=run_s, requests=len(prompts),
                   new_tokens=n_tok,
                   gen_s=gen_s, tokens_per_s=n_tok / gen_s,
                   in_process_tokens_per_s=gpt["tokens_per_s"],
                   ttft_ms_p50_p90=ttft, tpot_ms_p50_p90=tpot,
                   flash_launches=fwd, prefills=prefills,
                   compared_tokens=compared, near_ties=ties,
                   stream=want_kind, ring=ring_row,
                   domain_mib=(None if domain_bytes is None
                               else domain_bytes / 2**20))
        print(f"serve[{path}]: GPT-2 125M replica (num_gpus=1) up in "
              f"{up_s:.2f} s (`serve.run` {run_s:.2f} s: the controller's "
              f"start and the deploy; then the GPU worker's start, the "
              f"engine's weights, warm-up and graph capture); "
              f"{len(prompts)} concurrent {want_kind} streams x "
              f"{SERVE_MAX_NEW} tokens in {gen_s:.3f} s = "
              f"{n_tok / gen_s:.1f} tok/s (in-process `gpt` phase "
              f"{gpt['tokens_per_s']:.1f}); TTFT p50/p90 "
              f"{ttft[0]:.2f}/{ttft[1]:.2f} ms, TPOT p50/p90 "
              f"{tpot[0]:.3f}/{tpot[1]:.3f} ms (request recorder, client "
              f"records); flash launches in the replica {fwd} = "
              f"{cfg.n_layer} x {prefills} prefills; tokens equal to the "
              f"`gpt` phase's: {compared} compared, {len(ties)} near-tie "
              f"stop(s)"
              + (f"; ring enqueued {ring_row['enqueued']} drained "
                 f"{ring_row['drained']} in {ring_row['drain_batches']} "
                 f"batches, its domain segment "
                 f"{domain_bytes / 2**20:.1f} MiB of /dev/shm (slots for "
                 f"a {cfg.max_seq_len}-token prompt)" if ring_path else "")
              + f" (card: {card})")
        if ring_path:
            # the kill stream takes the Python path: a native stream has
            # no failover (as in the JAX package)
            os.environ.pop(dispatch.ENV_FLAG, None)
            row["kill"] = kill = _serve_kill(
                handle, prompts[0], gpt["tokens"][0], gpt["gaps"][0], free0,
                device)
            print(f"serve[kill]: the replica killed after "
                  f"{kill['killed_after_tokens']} of {SERVE_KILL_MAX_NEW} "
                  f"streamed tokens; the card's free memory back to "
                  f"{kill['free_after_kill'] / 2**30:.2f} GiB in "
                  f"{kill['free_after_kill_s']:.2f} s (before the deployment"
                  f" {free0 / 2**30:.2f} GiB, floor "
                  f"{kill['free_floor'] / 2**30:.2f}: arena "
                  f"{kill['arena_record']['nbytes'] / 2**20:.1f} MiB + 256 "
                  f"MiB); arena {kill['arena_id'][:12]} reclaimed, "
                  f"serve_llm_arenas_reclaimed_total "
                  f"{kill['reclaimed_total']}; the stream resumed on the "
                  f"replacement ({kill['replayed_tokens']} replayed), its "
                  f"first token {kill['replacement_first_token_s']:.2f} s "
                  f"after the kill; the replacement's answer equals the "
                  f"stream and the `gpt` phase's tokens "
                  f"({kill['compared_tokens']} compared, "
                  f"{len(kill['near_ties'])} near-tie stop(s)) (card: "
                  f"{card})")
    finally:
        os.environ.pop(dispatch.ENV_FLAG, None)
        serve.shutdown()
        ray_tpu_torch.shutdown()
    _assert_clean()
    free_end, free_end_s = _wait_free(device, free0 - SERVE_MEM_SLACK, 60)
    if device == "cuda":
        assert free_end >= free0 - SERVE_MEM_SLACK, (free0, free_end)
    row.update(free_after_shutdown=free_end)
    print(f"serve[{path}]: shutdown left no process of the port's session "
          f"and no /dev/shm/ray_tpu_torch_* segment (store, ring, FIFOs);"
          f" the card's free memory {free_end / 2**30:.2f} GiB (before "
          f"{free0 / 2**30:.2f})")
    return row


def phase_serve(gpt, engine_cfg=None, buckets=GPT_BUCKETS,
                prompt_lens=GPT_PROMPT_LENS, store_bytes=SERVE_STORE_BYTES,
                device="cuda"):
    """The port's Serve on the card (module docstring, phase 9): GPT-2
    125M from a num_gpus=1 replica through the handle, on the Python
    router path and on the native request ring, each in a node of its
    own; on the ring's node the replica is killed mid-stream. `gpt` is
    the `gpt` phase's row (its tokens, the eager run's top-2 gaps,
    tok/s)."""
    engine_cfg = engine_cfg or gpt_mod.GPTConfig.gpt2_125m()
    prompts = _prompts(engine_cfg, prompt_lens, 1)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    shm_free = shutil.disk_usage("/dev/shm").free
    if shm_free < store_bytes:
        raise RuntimeError(
            f"serve: /dev/shm has {shm_free} bytes free, under the store's "
            f"{store_bytes}")
    assert not _port_processes(), _port_processes()
    free0 = _free_card_bytes(device)
    rows = {path: _serve_cluster(path, gpt, engine_cfg, buckets, prompts,
                                 store_bytes, free0, device)
            for path in ("python", "ring")}
    return dict(paths=rows, free_before=free0,
                launches=sum(r["flash_launches"] for r in rows.values()))


TRAIN_DIST_DIR = Path(__file__).resolve().parent / "smoke_train_dist"
TRAIN_DIST_K1_STEPS = 6    # steps at K=1; the first attempt dies after them
TRAIN_DIST_CKPT_STEP = 4   # the gang checkpoint goes with this step's report
TRAIN_DIST_K4_CALLS = 2    # then K=4 calls: 14 steps in all
TRAIN_DIST_LOSS_RTOL = 1e-3  # each loss against `train`'s K=1 loss


def _process_start_wall():
    """This process's start on the wall clock (Linux: its start in clock
    ticks after boot, /proc/self/stat field 22, plus the boot time)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime "))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def _dist_loop(config):
    """`train_dist`'s training loop, in the `TorchTrainer`'s GPU worker.
    It imports this script as a module there (the checkout's root is on
    every worker's path): sent by value, it holds no reference to torch,
    so the Tune trial actor and the train controller that unpickle the
    trainer run without torch."""
    import chip_smoke

    chip_smoke._dist_train_worker(config)


def _dist_train_worker(config):
    """GPT-2 125M as the `train` phase wires it (same seed, weights and
    batch), each step's gradients and loss averaged over the process
    group by one all-reduce of a flat bucket inside the step, through
    `TrainStepRunner`: K=1 up to step 6 (the gang checkpoint of the carry
    with step 4's report), then K=4 twice. The first attempt (no restore
    checkpoint) dies after step 6's report; the replacement restores the
    step-4 checkpoint into its live carry, checks each leaf's checksum
    against the checkpoint's, and trains on from step 5."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train._internal import session as session_mod

    t_start = time.time()
    proc_start = _process_start_wall()
    device = config["device"]
    assert dist.is_initialized(), "train_dist: the worker has no group"
    backend, world = dist.get_backend(), dist.get_world_size()
    if device == "cuda":
        # the worker's card is cuda:0 (its CUDA_VISIBLE_DEVICES grant)
        assert backend == "nccl" and torch.cuda.current_device() == 0, \
            (backend, torch.cuda.current_device())
    # this attempt's main path: counts at 0 here, read at each report
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.time()
    torch.zeros(1, device=device).sum().item()  # the process's first op
    first_op_s = time.time() - t0
    cfg = getattr(gpt_mod.GPTConfig, config["model"])(
        remat=False, max_seq_len=config["seq"])
    batch, seq = config["batch"], config["seq"]
    model, inputs, targets = _train_setup(
        "gpt", cfg, config["seed"], batch, seq,
        partial(flash_attention, causal=True), device)
    model_s = time.time() - t0  # the weights drawn, the model, the batch
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4,
                            capturable=torch.device(device).type == "cuda")
    carry = _adamw_carry(model, opt)
    params = list(carry["params"].values())
    numels = [p.numel() for p in params]
    setup_s = time.time() - t0  # the model, AdamW and the carry

    def train_step(carry, data):
        loss = _loss(model, data["x"], data["y"])
        loss.backward()
        # the gang's mean gradient and loss: one flat bucket, one
        # all-reduce, captured with the rest of the step
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1).float()])
        dist.all_reduce(flat)
        flat.div_(world)
        for p, g in zip(params, flat[:-1].split(numels)):
            p.grad = g.view_as(p)
        opt.step()
        opt.zero_grad(set_to_none=True)
        # a copy: a view would keep the whole bucket alive as the step's
        # output (K times over in a K-step graph)
        return carry, flat[-1].clone()

    start, restore_s, sums_equal, checksum_s = 0, None, None, None
    resume = train.get_checkpoint()
    if resume is not None:
        t0 = time.perf_counter()
        restored = array_checkpoint.restore_sharded(resume, carry)
        with torch.no_grad():
            for got, live in zip(_tensor_leaves(restored),
                                 _tensor_leaves(carry)):
                live.copy_(got)
        del restored
        if device == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        with open(os.path.join(resume.path, "checksums.json")) as f:
            want_sums = json.load(f)
        t0 = time.perf_counter()
        sums = [_checksum(x) for x in _tensor_leaves(carry)]
        checksum_s = time.perf_counter() - t0
        sums_equal = sums == want_sums
        assert sums_equal, "train_dist: the restored carry's checksums " \
            "differ from the checkpoint's"
        start = int(next(iter(carry["step"].values())))
    data = {"x": inputs, "y": targets}
    tokens = batch * seq
    flops = gpt_mod.flops_per_token(cfg, seq) * tokens
    step = start

    def report(k, losses, ms, miss, runner, checkpoint=None, **extra):
        rec = runner.step_stats(1)[0]
        train.report(dict(
            step=step, k=k, losses=losses, loss=losses[-1], step_ms=ms,
            miss=miss, resumed_from=start, restore_s=restore_s,
            checksums_equal=sums_equal, backend=backend, world=world,
            fwd_launches=flash_attention.launches,
            bwd_launches=flash_attention_bwd.launches,
            checkpoint_ms=rec.get("checkpoint_ms", 0.0),
            cache=runner.cache_stats(),
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if device == "cuda" else 0.0),
            pid=os.getpid(), proc_start=proc_start, t_start=t_start,
            first_op_s=first_op_s, model_s=model_s, setup_s=setup_s,
            checksum_s=checksum_s,
            t_wall=time.time(),
            **extra), checkpoint=checkpoint)

    for k, until in ((1, TRAIN_DIST_K1_STEPS),
                     (4, TRAIN_DIST_K1_STEPS + 4 * TRAIN_DIST_K4_CALLS)):
        runner = TrainStepRunner(
            train_step, steps_per_call=k, tokens_per_step=tokens,
            flops_per_step=flops, peak_flops=PEAK_BF16_FLOPS, device=device)
        batches = data if k == 1 else stack_batches([data] * k)
        miss = True
        while step < until:
            t0 = time.perf_counter()
            carry, loss = runner.run(carry, batches)
            losses = [float(x) for x in loss.reshape(-1).tolist()]
            ms = (time.perf_counter() - t0) * 1e3 / k
            step += k
            ckpt, extra = None, {}
            if step == TRAIN_DIST_CKPT_STEP:
                t0 = time.perf_counter()
                ckpt = array_checkpoint.save_to_checkpoint(carry)
                extra["save_s"] = time.perf_counter() - t0
                with open(os.path.join(ckpt.path, "checksums.json"),
                          "w") as f:
                    json.dump([_checksum(x) for x in _tensor_leaves(carry)],
                              f)
            report(k, losses, ms, miss, runner, checkpoint=ckpt, **extra)
            miss = False
            if step == TRAIN_DIST_K1_STEPS and resume is None:
                # the rank dies on its first attempt, after its step-4
                # report returned (the gang committed that checkpoint)
                # and once the controller holds step 6's report. An empty
                # queue only says that the worker's poll took it: the
                # poll's reply may not have left yet, and the death would
                # lose it. The controller polls again only after that
                # reply came, so wait for its next poll to block on the
                # queue.
                sess = session_mod.get_session()
                deadline = time.monotonic() + 120.0
                while not sess.result_queue.empty() or \
                        not sess.result_queue.not_empty._waiters:
                    assert time.monotonic() < deadline, \
                        "train_dist: the controller did not poll again " \
                        "after step 6's report"
                    time.sleep(0.005)
                with open(os.path.join(train.get_context().get_trial_dir(),
                                       "killed_at"), "w") as f:
                    f.write(repr(time.time()))
                os._exit(1)
        global_cache().evict(runner._compiled)
        del runner, batches
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def phase_train_dist(want_losses, ref_ms, model="gpt2_125m", batch=16,
                     seq=1024, seed=3, device="cuda"):
    """The distributed train plane on the card (module docstring, phase
    10). `want_losses` is the `train` phase's K=1 loss trajectory (step i
    at index i - 1), `ref_ms` its graphed step ms at K=1 and K=4."""
    from ray_tpu_torch import train as train_mod
    from ray_tpu_torch.air import (CheckpointConfig, FailureConfig,
                                   RunConfig, ScalingConfig)

    card = card_line() if device == "cuda" else "cpu"
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    assert not _port_processes(), _port_processes()
    shutil.rmtree(TRAIN_DIST_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=256 << 20,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    init_s = time.perf_counter() - t0
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 1
        trainer = train_mod.TorchTrainer(
            _dist_loop,
            train_loop_config=dict(device=device, model=model, batch=batch,
                                   seq=seq, seed=seed),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            backend_config=train_mod.TorchConfig(
                distributed="on",
                platform="cuda" if device == "cuda" else "cpu"),
            run_config=RunConfig(
                name="train_dist", storage_path=str(TRAIN_DIST_DIR),
                checkpoint_config=CheckpointConfig(num_to_keep=2),
                failure_config=FailureConfig(max_failures=1)))
        fit_wall = time.time()
        result = trainer.fit()
        fit_s = time.time() - fit_wall
        (killed,) = glob.glob(str(TRAIN_DIST_DIR / "train_dist" / "*" /
                                  "killed_at"))
        with open(killed) as f:
            killed_at = float(f.read())
    finally:
        ray_tpu_torch.shutdown()
    _assert_clean()
    shutil.rmtree(TRAIN_DIST_DIR, ignore_errors=True)

    hist = [m for m in result.metrics_history if "step" in m]
    first = [m for m in hist if m["resumed_from"] == 0]
    second = [m for m in hist if m["resumed_from"] != 0]
    k1_end = TRAIN_DIST_K1_STEPS
    assert [m["step"] for m in first] == list(range(1, k1_end + 1)), hist
    assert [m["step"] for m in second] == [
        *range(TRAIN_DIST_CKPT_STEP + 1, k1_end + 1),
        *range(k1_end + 4, k1_end + 4 * TRAIN_DIST_K4_CALLS + 1, 4)], hist
    assert result.metrics["resumed_from"] == TRAIN_DIST_CKPT_STEP
    assert result.metrics["step"] == k1_end + 4 * TRAIN_DIST_K4_CALLS
    assert first[-1]["pid"] != second[0]["pid"]
    assert all(m["checksums_equal"] for m in second), second
    want_backend = "nccl" if device == "cuda" else "gloo"
    assert {(m["backend"], m["world"]) for m in hist} == {(want_backend, 1)}
    # every loss against `train`'s K=1 loss at the same step
    worst = 0.0
    for m in hist:
        for j, loss in enumerate(m["losses"]):
            at = m["step"] - len(m["losses"]) + j  # the step's index
            assert np.isfinite(loss), m
            worst = max(worst, abs(loss - want_losses[at])
                        / abs(want_losses[at]))
    assert worst <= TRAIN_DIST_LOSS_RTOL, (worst, hist, want_losses)
    # each attempt's steps ran as graphs: one capture per K it ran, then
    # only replays (the process's cache: the K=1 and K=4 runners')
    for run in (first, second):
        cache = run[-1]["cache"]
        misses = len({m["k"] for m in run})
        assert cache["misses"] == misses and cache["retraces"] == 0 and \
            cache["hits"] == len(run) - misses, (cache, run)
    # each attempt's kernels: n_layer forwards and twice that backward
    # kernels per step it ran
    n_layer = getattr(gpt_mod.GPTConfig, model)().n_layer
    launches = {}
    for key in ("fwd_launches", "bwd_launches"):
        per = 1 if key == "fwd_launches" else BWD_KERNELS_PER_CALL
        for run in (first, second):
            steps = run[-1]["step"] - run[0]["step"] + len(run[0]["losses"])
            want = n_layer * steps * per if device == "cuda" else 0
            assert run[-1][key] == want, (key, run[-1][key], want)
        launches[key] = first[-1][key] + second[-1][key]
    k1_ms = [m["step_ms"] for m in hist if m["k"] == 1 and not m["miss"]]
    k4_ms = [m["step_ms"] for m in hist if m["k"] == 4 and not m["miss"]]
    row = dict(
        init_s=init_s, fit_s=fit_s,
        fit_to_worker_s=first[0]["t_start"] - fit_wall,
        fit_to_first_report_s=first[0]["t_wall"] - fit_wall,
        fit_to_worker_spawn_s=first[0]["proc_start"] - fit_wall,
        kill_to_replacement_report_s=second[0]["t_wall"] - killed_at,
        kill_to_replacement_spawn_s=second[0]["proc_start"] - killed_at,
        kill_to_replacement_start_s=second[0]["t_start"] - killed_at,
        spawn_to_loop_s=[m[0]["t_start"] - m[0]["proc_start"]
                         for m in (first, second)],
        first_op_s=[m[0]["first_op_s"] for m in (first, second)],
        model_s=[m[0]["model_s"] for m in (first, second)],
        setup_s=[m[0]["setup_s"] for m in (first, second)],
        first_call_s=[m[0]["step_ms"] * m[0]["k"] / 1e3
                      for m in (first, second)],
        checksum_s=second[0]["checksum_s"],
        peak_gib_by_run={f"{a}:k{m['k']}": m["peak_gib"]
                         for a, run in (("first", first), ("second", second))
                         for m in run},
        replacement_start_to_report_s=second[0]["t_wall"]
        - second[0]["t_start"],
        restore_s=second[0]["restore_s"],
        save_s=first[TRAIN_DIST_CKPT_STEP - 1]["save_s"],
        checkpoint_persist_ms=first[TRAIN_DIST_CKPT_STEP]["checkpoint_ms"],
        k1_step_ms=statistics.median(k1_ms), k1_step_ms_all=k1_ms,
        k4_step_ms=statistics.median(k4_ms), k4_step_ms_all=k4_ms,
        ref_ms=ref_ms, worst_loss_rel=worst,
        peak_gib=max(m["peak_gib"] for m in hist),
        fwd_launches=launches["fwd_launches"],
        bwd_launches=launches["bwd_launches"],
        steps=[m["step"] for m in hist], backend=want_backend)
    print(f"train_dist: node up {init_s:.2f} s; fit() to the GPU worker's "
          f"process {row['fit_to_worker_spawn_s']:.2f} s (trial actor, "
          f"controller, placement group), to its loop "
          f"{row['fit_to_worker_s']:.2f} s (the process's imports, CUDA "
          f"context, {want_backend} group: {row['spawn_to_loop_s'][0]:.2f} "
          f"s), to its first report {row['fit_to_first_report_s']:.2f} s "
          f"(the process's first CUDA op {row['first_op_s'][0]:.2f} s, "
          f"model and carry {row['setup_s'][0]:.2f} s (of it the model "
          f"{row['model_s'][0]:.2f} s), the first call "
          f"{row['first_call_s'][0]:.2f} s); fit() {fit_s:.2f} s in all "
          f"(card: {card})")
    print(f"train_dist: step ms K=1 {row['k1_step_ms']:.2f} (runs "
          f"{[round(x, 2) for x in k1_ms]}) vs `train` K=1 "
          f"{ref_ms[0]:.2f}; K=4 {row['k4_step_ms']:.2f} vs `train` K=4 "
          f"{ref_ms[1]:.2f}; the all-reduce inside each captured step")
    print(f"train_dist: step-4 checkpoint staged in {row['save_s']:.2f} s, "
          f"persisted in {row['checkpoint_persist_ms']:.0f} ms (step "
          f"profiler's checkpoint_ms); rank killed after step "
          f"{first[-1]['step']}: the replacement's first report "
          f"{row['kill_to_replacement_report_s']:.2f} s after the kill (its "
          f"process {row['kill_to_replacement_spawn_s']:.2f} s after, its "
          f"loop {row['kill_to_replacement_start_s']:.2f} s after; loop to "
          f"report {row['replacement_start_to_report_s']:.2f} s: first CUDA "
          f"op {row['first_op_s'][1]:.2f} s, model and carry "
          f"{row['setup_s'][1]:.2f} s (model {row['model_s'][1]:.2f} s), "
          f"restore into the live carry "
          f"{row['restore_s']:.2f} s, checksums {row['checksum_s']:.2f} s, "
          f"the first call {row['first_call_s'][1]:.2f} s), every leaf's "
          f"checksum equal to the checkpoint's; resumed_from "
          f"{result.metrics['resumed_from']}, step {result.metrics['step']}")
    print(f"train_dist: steps {row['steps']}; worst loss rel difference "
          f"from `train` K=1 {worst:.2e} (tol {TRAIN_DIST_LOSS_RTOL}); "
          f"launches fwd {row['fwd_launches']} bwd {row['bwd_launches']}; "
          f"peak card memory in the worker {row['peak_gib']:.2f} GiB (by "
          f"report {row['peak_gib_by_run']})")
    return row


TRAIN_DATA_DIR = Path(__file__).resolve().parent / "smoke_train_data"
TRAIN_DATA_BLOCKS = 32     # the dataset's blocks
TRAIN_DATA_K1_STEPS = 4    # steps at K=1, then K=4 calls:
TRAIN_DATA_K4_CALLS = 7    # 32 steps in all, one pass over the rows
# each loss against the eager reference's: sound runs on the H100 read
# 5.2e-6-6.6e-6 (PERF.md); the batches' identity is checked exactly
TRAIN_DATA_LOSS_RTOL = 1e-4


def _split_xy(batch):
    """`map_batches` (run in tasks): each row's first T tokens are the
    inputs, its last T the targets."""
    toks = batch["tokens"]
    return {"id": batch["id"], "x": toks[:, :-1], "y": toks[:, 1:]}


def _token_checksum(a):
    """A batch's identity: its tokens weighted by their flat position,
    so rows out of order or shifted change it."""
    a = np.asarray(a, np.int64)
    return int((a.reshape(-1) * np.arange(1, a.size + 1)).sum())


def _data_tokens(rows, seq, vocab, seed):
    """The dataset's token rows, [rows, seq + 1] int32 from numpy."""
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)


def _data_loop(config):
    """`train_data`'s training loop, in the `TorchTrainer`'s GPU worker
    (sent by value without torch, as `_dist_loop`)."""
    import chip_smoke

    chip_smoke._data_train_worker(config)


def _data_train_worker(config):
    """GPT-2 125M as the `train` phase builds it (same seed and weights),
    fed from the worker's `streaming_split` shard: numpy batches from
    `iter_batches`, each copied to pinned host memory and then to the
    card (`non_blocking`), into `TrainStepRunner` at K=1 for
    TRAIN_DATA_K1_STEPS steps, then K=4 for TRAIN_DATA_K4_CALLS calls.
    Each report carries the ids of the rows its steps consumed (a
    streaming split hands blocks out in completion order), the checksums
    of the `x` and `y` each step was given, and the host ms the loop
    waited in the iterator."""
    from ray_tpu_torch import train

    device = config["device"]
    batch, seq = config["batch"], config["seq"]
    # this worker's main path: counts at 0 here, read at each report
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    cfg = getattr(gpt_mod.GPTConfig, config["model"])(
        remat=False, max_seq_len=seq)
    model, _, _ = _train_setup("gpt", cfg, config["seed"], batch, seq,
                               partial(flash_attention, causal=True),
                               device)
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

    shard = train.get_dataset_shard("train")
    ids, sums, waits = [], [], []

    def device_batches():
        it = iter(shard.iter_batches(batch_size=batch, drop_last=True,
                                     prefetch_batches=2))
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            waits.append((time.perf_counter() - t0) * 1e3)
            if b is None:
                return
            ids.append(b["id"].tolist())
            sums.append([_token_checksum(b["x"]), _token_checksum(b["y"])])
            out = {}
            for key in ("x", "y"):
                host = torch.from_numpy(b[key])
                if device == "cuda":
                    host = host.pin_memory()
                out[key] = host.to(device, non_blocking=True).long()
            yield out

    stream = device_batches()
    tokens = batch * seq
    flops = gpt_mod.flops_per_token(cfg, seq) * tokens
    step = 0
    for k, calls in ((1, TRAIN_DATA_K1_STEPS), (4, TRAIN_DATA_K4_CALLS)):
        runner = TrainStepRunner(
            train_step, steps_per_call=k, tokens_per_step=tokens,
            flops_per_step=flops, peak_flops=PEAK_BF16_FLOPS, device=device)
        for call in range(calls):
            n_ids, n_waits = len(ids), len(waits)
            t0 = time.perf_counter()
            carry, loss = runner.run(carry, stream)
            losses = [float(x) for x in loss.reshape(-1).tolist()]
            ms = (time.perf_counter() - t0) * 1e3 / k
            step += k
            rec = runner.step_stats(1)[0]
            train.report(dict(
                step=step, k=k, losses=losses, step_ms=ms, miss=call == 0,
                ids=ids[n_ids:], sums=sums[n_ids:],
                wait_ms=sum(waits[n_waits:]) / k,
                data_wait_ms=rec["data_wait_ms"] / k,
                fwd_launches=flash_attention.launches,
                bwd_launches=flash_attention_bwd.launches,
                cache=runner.cache_stats(),
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                          if device == "cuda" else 0.0)))
        global_cache().evict(runner._compiled)
        del runner
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    # one pass: the shard has no batch left
    assert next(stream, None) is None, "train_data: rows left in the shard"


def _data_reference(cfg, seed, batch, seq, toks, step_ids, device):
    """The eager losses of the worker's steps in this process: the same
    weights and AdamW (capturable on the card, as in the graphs), each
    step on the rows the worker consumed at that step."""
    model, _, _ = _train_setup("gpt", cfg, seed, batch, seq,
                               partial(flash_attention, causal=True),
                               device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4,
                            capturable=torch.device(device).type == "cuda")
    _adamw_carry(model, opt)
    losses = []
    for rows in step_ids:
        t = torch.from_numpy(toks[rows]).to(device).long()
        loss = _loss(model, t[:, :-1], t[:, 1:])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    del model, opt
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses


def phase_train_data(ref_ms, model="gpt2_125m", batch=16, seq=1024,
                     seed=3, device="cuda"):
    """GPT-2 125M trained from a streaming Dataset (module docstring,
    phase 11). `ref_ms` is the `train` phase's graphed step ms at K=1
    and K=4."""
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch import train as train_mod
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    t_phase = time.perf_counter()
    card = card_line() if device == "cuda" else "cpu"
    cfg = getattr(gpt_mod.GPTConfig, model)(remat=False, max_seq_len=seq)
    steps = TRAIN_DATA_K1_STEPS + 4 * TRAIN_DATA_K4_CALLS
    rows = steps * batch
    toks = _data_tokens(rows, seq, cfg.vocab_size, seed)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    assert not _port_processes(), _port_processes()
    shutil.rmtree(TRAIN_DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    init_s = time.perf_counter() - t0
    try:
        ds = rt_data.from_numpy(
            {"id": np.arange(rows, dtype=np.int64), "tokens": toks},
            parallelism=TRAIN_DATA_BLOCKS).map_batches(_split_xy)
        trainer = train_mod.TorchTrainer(
            _data_loop,
            train_loop_config=dict(device=device, model=model, batch=batch,
                                   seq=seq, seed=seed),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            backend_config=train_mod.TorchConfig(
                distributed="off",
                platform="cuda" if device == "cuda" else "cpu"),
            run_config=RunConfig(name="train_data",
                                 storage_path=str(TRAIN_DATA_DIR)),
            datasets={"train": ds})
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    _assert_clean()
    shutil.rmtree(TRAIN_DATA_DIR, ignore_errors=True)

    hist = [m for m in result.metrics_history if "step" in m]
    assert [m["step"] for m in hist] == [
        *range(1, TRAIN_DATA_K1_STEPS + 1),
        *range(TRAIN_DATA_K1_STEPS + 4, steps + 1, 4)], hist
    step_ids = [r for m in hist for r in m["ids"]]
    assert len(step_ids) == steps and all(len(r) == batch
                                          for r in step_ids)
    # every row once: one pass over the dataset, in the split's order
    assert sorted(i for r in step_ids for i in r) == list(range(rows))
    # each step was given the tokens of the rows it reported
    step_sums = [c for m in hist for c in m["sums"]]
    want_sums = [[_token_checksum(toks[r][:, :-1]),
                  _token_checksum(toks[r][:, 1:])] for r in step_ids]
    assert step_sums == want_sums, "train_data: x/y not the ids' rows"
    losses = [x for m in hist for x in m["losses"]]
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    t0 = time.perf_counter()
    want = _data_reference(cfg, seed, batch, seq, toks, step_ids, device)
    reference_s = time.perf_counter() - t0
    rel = [abs(g - w) / abs(w) for g, w in zip(losses, want)]
    worst = max(rel)
    assert worst <= TRAIN_DATA_LOSS_RTOL, (worst, losses, want)
    # the steps ran as graphs: one capture per K, then only replays
    cache = hist[-1]["cache"]
    assert cache["misses"] == 2 and cache["retraces"] == 0 and \
        cache["hits"] == len(hist) - 2, cache
    # n_layer forward kernels a step, twice that backward (the plain
    # path on the CPU counts none)
    n_layer = cfg.n_layer
    fwd, bwd = hist[-1]["fwd_launches"], hist[-1]["bwd_launches"]
    if device == "cuda":
        assert fwd == n_layer * steps, (fwd, n_layer * steps)
        assert bwd == BWD_KERNELS_PER_CALL * n_layer * steps, bwd
    k1 = [m for m in hist if m["k"] == 1 and not m["miss"]]
    k4 = [m for m in hist if m["k"] == 4 and not m["miss"]]
    row = dict(
        init_s=init_s, fit_s=fit_s, reference_s=reference_s,
        rows=rows, blocks=TRAIN_DATA_BLOCKS, steps=steps,
        k1_step_ms=statistics.median(m["step_ms"] for m in k1),
        k1_step_ms_all=[m["step_ms"] for m in k1],
        k4_step_ms=statistics.median(m["step_ms"] for m in k4),
        k4_step_ms_all=[m["step_ms"] for m in k4],
        ref_ms=ref_ms,
        wait_ms_per_step=statistics.median(m["wait_ms"] for m in k1 + k4),
        wait_ms_all=[m["wait_ms"] for m in hist],
        data_wait_ms_per_step=statistics.median(
            m["data_wait_ms"] for m in k1 + k4),
        first_ids=step_ids[0][:4], worst_loss_rel=worst,
        peak_gib=max(m["peak_gib"] for m in hist),
        fwd_launches=fwd, bwd_launches=bwd,
        phase_s=time.perf_counter() - t_phase)
    print(f"train_data: {rows} rows x {seq + 1} tokens in "
          f"{TRAIN_DATA_BLOCKS} blocks, map_batches in tasks, "
          f"streaming_split(1) to a TorchTrainer GPU worker; node up "
          f"{init_s:.2f} s, fit() {fit_s:.2f} s (card: {card})")
    print(f"train_data: step ms K=1 {row['k1_step_ms']:.2f} (runs "
          f"{[round(x, 2) for x in row['k1_step_ms_all']]}) vs `train` K=1 "
          f"{ref_ms[0]:.2f}; K=4 {row['k4_step_ms']:.2f} vs `train` K=4 "
          f"{ref_ms[1]:.2f}; the loop waited {row['wait_ms_per_step']:.3f} "
          f"ms a step in the iterator (median; the runner's data wait "
          f"{row['data_wait_ms_per_step']:.3f} ms, with the copy and "
          f"stack)")
    print(f"train_data: {steps} steps, worst loss rel difference from the "
          f"eager reference on the same rows {worst:.2e} (tol "
          f"{TRAIN_DATA_LOSS_RTOL}); each step's x/y checksums equal its "
          f"ids' rows'; first batch's ids {row['first_ids']}; "
          f"launches fwd {fwd} bwd {bwd}; peak card memory in the worker "
          f"{row['peak_gib']:.2f} GiB; the phase {row['phase_s']:.1f} s")
    return row


DAG_BATCH = 8              # the fused chain's rows, at T=1024
DAG_ACTOR_IDS = (8, 128)   # the actor graph's token ids
DAG_FUSED_RUNS = 20        # timed fused executes, and eager chains
DAG_EXECUTES = 50          # timed compiled executes of the actor graph
DAG_LAZY_EXECUTES = 20     # timed lazy executes of the same graph


def _fused_stages(net):
    """The fused chain's three stages over `net`: the forward, the last
    position's logits, the greedy ids (with those logits)."""
    def forward(ids):
        with torch.no_grad():
            return net(ids)

    def last(logits):
        return logits[:, -1, :]

    def greedy(last_logits):
        return torch.argmax(last_logits, dim=-1), last_logits

    return forward, last, greedy


def _dag_model(model, seed, device):
    """(config, GPT) of `model` with inference weights from `seed`."""
    cfg = getattr(gpt_mod.GPTConfig, model)()
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, gpt_mod.GPT.from_params(
        cfg, gpt_mod.init_params(cfg, gen, device=device),
        attention_fn=partial(flash_attention, causal=True))


@ray_tpu_torch.remote(num_gpus=1)
class _DagModelActor:
    """GPT-2 with random weights from `seed` on the actor's card: token
    ids to the last position's logits (a CUDA tensor), and logits to the
    greedy ids (on the host)."""

    def __init__(self, model, seed, device):
        _, self.net = _dag_model(model, seed, device)
        self.device = device

    def info(self):
        return dict(pid=os.getpid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))

    def last_logits(self, ids):
        with torch.no_grad():
            return self.net(ids.to(self.device))[:, -1, :]

    def greedy(self, logits):
        return torch.argmax(logits, dim=-1).cpu()

    def reset_counts(self):
        flash_attention.launches = 0

    def counts(self):
        return flash_attention.launches


@ray_tpu_torch.remote
class _DagConsumer:
    """A CPU actor that consumes the greedy ids."""

    def __init__(self):
        self.calls = 0

    def consume(self, ids):
        self.calls += 1
        return {"ids": ids, "calls": self.calls, "device": str(ids.device)}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _check_greedy(ids, logits, want_ids, want_logits, label):
    """The greedy ids equal the reference's, but where its top-2 logit
    gap is a near tie; the logits within LOGIT_ATOL. Returns the logits'
    max difference and the near ties."""
    diff = float((logits.float() - want_logits.float()).abs().max())
    assert diff <= LOGIT_ATOL, (label, diff)
    gaps = _top2_gap(want_logits).tolist()
    _, ties = _near_tie_compare([[int(x)] for x in ids.tolist()],
                                [[int(x)] for x in want_ids.tolist()],
                                [[g] for g in gaps], label)
    return diff, ties


def phase_dag(model="gpt2_125m", batch=DAG_BATCH, seq=1024,
              actor_ids=DAG_ACTOR_IDS, seed=1, device="cuda"):
    """The compiled DAG on the card (module docstring, phase 12)."""
    from ray_tpu_torch import dag as dag_mod

    t_phase = time.perf_counter()
    card = card_line() if device == "cuda" else "cpu"
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- the fused chain: three torch_stages, one compiled_step --------------
    cfg, net = _dag_model(model, seed, device)
    forward, last, greedy = _fused_stages(net)
    node = dag_mod.InputNode()
    for fn in (forward, last, greedy):
        node = dag_mod.bind(dag_mod.torch_stage(fn), node)
    gen = np.random.default_rng(seed)
    inputs = [torch.from_numpy(gen.integers(0, cfg.vocab_size, (batch, seq)))
              .to(device) for _ in range(2)]

    def eager(x):
        return greedy(last(forward(x)))

    # (ids, a copy of the last logits: not a view that keeps [B, T, V])
    want = [(i, lg.clone()) for i, lg in map(eager, inputs)]
    _sync(device)
    stats0 = cache_stats()
    compiled = node.experimental_compile()
    assert compiled._fused is not None, "the chain was not fused"
    flash_attention.launches = 0
    try:
        t0 = time.perf_counter()
        held = compiled.execute(inputs[0])  # the miss: eager, then capture
        _sync(device)
        miss_s = time.perf_counter() - t0
        other = compiled.execute(inputs[1])  # a replay over `held`'s graph
        fused_ms = []
        for i in range(DAG_FUSED_RUNS):
            t0 = time.perf_counter()
            out = compiled.execute(inputs[i % 2])
            _sync(device)
            fused_ms.append((time.perf_counter() - t0) * 1e3)
        executes = 2 + DAG_FUSED_RUNS
        fused_launches = flash_attention.launches
        stats1 = cache_stats()
        # two results held across executes stay distinct, each its input's
        diffs, ties = [], []
        for got, (w_ids, w_last) in zip((held, other), want):
            d, t = _check_greedy(got[0], got[1], w_ids, w_last, "dag fused")
            diffs.append(d)
            ties += t
        assert held[1].data_ptr() != other[1].data_ptr() != out[1].data_ptr()
        distinct = not torch.equal(held[1], other[1])
        assert distinct, "dag: two held results are equal"
    finally:
        compiled.teardown()
    # one graph for the chain: one miss, then only hits, no retrace
    assert stats1["misses"] == stats0["misses"] + 1, (stats0, stats1)
    assert stats1["hits"] == stats0["hits"] + executes - 1, (stats0, stats1)
    assert stats1["retraces"] == stats0["retraces"], (stats0, stats1)
    if device == "cuda":
        assert fused_launches == cfg.n_layer * executes, fused_launches
    eager_ms = []
    for i in range(DAG_FUSED_RUNS):
        t0 = time.perf_counter()
        eager(inputs[i % 2])
        _sync(device)
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"dag fused: 3 torch_stages over GPT-2 B={batch} T={seq} as one "
          f"compiled_step ({stats1['misses'] - stats0['misses']} graph, "
          f"{stats1['hits'] - stats0['hits']} replays, miss "
          f"{miss_s:.2f} s); execute {statistics.median(fused_ms):.3f} ms vs "
          f"eager chain {statistics.median(eager_ms):.3f} ms (median of "
          f"{DAG_FUSED_RUNS}); last logits vs eager max diff "
          f"{max(diffs):.3g} (tol {LOGIT_ATOL}), near ties {len(ties)}; two "
          f"held results distinct {distinct}; forward launches "
          f"{fused_launches} = {fused_launches / executes:.0f} an execute "
          f"(card: {card})")
    fused_row = dict(miss_s=miss_s, execute_ms=statistics.median(fused_ms),
                     execute_ms_all=fused_ms,
                     eager_ms=statistics.median(eager_ms),
                     max_logit_diff=max(diffs), near_ties=len(ties),
                     executes=executes, launches=fused_launches,
                     held_distinct=distinct)
    del held, other, out, want, inputs, net
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # -- the actor graph on channels -----------------------------------------
    ids = torch.from_numpy(gen.integers(0, cfg.vocab_size, actor_ids))
    _, ref_net = _dag_model(model, seed, device)
    with torch.no_grad():
        ref_logits = ref_net(ids.to(device))[:, -1, :]
    ref_ids = torch.argmax(ref_logits, dim=-1).cpu()
    del ref_net
    assert not _port_processes(), _port_processes()
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=256 << 20,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    init_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        gpu = _DagModelActor.remote(model, seed, device)
        consumer = _DagConsumer.remote()
        info = ray_tpu_torch.get(gpu.info.remote(), timeout=600)
        ray_tpu_torch.get(consumer.consume.remote(torch.zeros(1)),
                          timeout=600)
        actors_s = time.perf_counter() - t0
        assert info["visible"] == "0", info
        logits_node = dag_mod.bind(gpu.last_logits, dag_mod.InputNode())
        graph = dag_mod.MultiOutputNode([
            dag_mod.bind(consumer.consume,
                         dag_mod.bind(gpu.greedy, logits_node)),
            logits_node])
        t0 = time.perf_counter()
        compiled = graph.experimental_compile()
        compile_s = time.perf_counter() - t0
        assert compiled._channels is not None, "not lowered onto channels"
        ray_tpu_torch.get(gpu.reset_counts.remote(), timeout=60)
        try:
            t0 = time.perf_counter()
            first, first_logits = compiled.execute(ids)
            first_s = time.perf_counter() - t0
            rtt = []
            for _ in range(DAG_EXECUTES):
                t0 = time.perf_counter()
                got, logits = compiled.execute(ids)
                rtt.append((time.perf_counter() - t0) * 1e3)
            actor_launches = ray_tpu_torch.get(gpu.counts.remote(),
                                               timeout=60)
        finally:
            compiled.teardown()
        diffs, ties = [], []
        for res, lg in ((first, first_logits), (got, logits)):
            assert res["device"] == "cpu", res
            assert lg.device.type == torch.device(device).type, lg.device
            d, t = _check_greedy(res["ids"], lg, ref_ids, ref_logits,
                                 "dag actor graph")
            diffs.append(d)
            ties += t
        diff = max(diffs)
        assert got["calls"] == DAG_EXECUTES + 2, got
        if device == "cuda":
            assert actor_launches == cfg.n_layer * (DAG_EXECUTES + 1), \
                actor_launches
        # the same graph, lazily: tasks and objects per call
        lazy = []
        for _ in range(DAG_LAZY_EXECUTES):
            t0 = time.perf_counter()
            lazy_out = ray_tpu_torch.get(graph.execute(ids), timeout=600)
            lazy.append((time.perf_counter() - t0) * 1e3)
        assert torch.equal(lazy_out[0]["ids"], got["ids"])
        assert torch.equal(lazy_out[1].cpu(), logits.cpu())
        del logits, first_logits, lazy_out
    finally:
        ray_tpu_torch.shutdown()
    _assert_clean()
    actor_row = dict(init_s=init_s, actors_s=actors_s, compile_s=compile_s,
                     first_s=first_s, rtt_ms=statistics.median(rtt),
                     rtt_ms_p90=statistics.quantiles(rtt, n=10)[-1],
                     lazy_ms=statistics.median(lazy),
                     max_logit_diff=diff, near_ties=len(ties),
                     executes=DAG_EXECUTES + 1, launches=actor_launches,
                     ids=got["ids"].tolist())
    print(f"dag actor graph: a num_gpus=1 actor (GPT-2, ids {list(actor_ids)}"
          f" to the last logits and the greedy ids) and a CPU actor on "
          f"channels, MultiOutputNode [ids, logits]: ids equal in-process "
          f"greedy (near ties {len(ties)}), logits on the driver's "
          f"{torch.device(device).type} (max diff {diff:.3g}); compiled "
          f"execute {actor_row['rtt_ms']:.3f} ms (median of {DAG_EXECUTES}, "
          f"p90 {actor_row['rtt_ms_p90']:.3f}) vs lazy execute() "
          f"{actor_row['lazy_ms']:.3f} ms (median of {DAG_LAZY_EXECUTES}); "
          f"actors up {actors_s:.2f} s, compile {compile_s:.3f} s; actor "
          f"launches {actor_launches}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s (card: {card})")
    return dict(fused=fused_row, actor=actor_row,
                phase_s=time.perf_counter() - t_phase)


SOAK_DIR = Path(__file__).resolve().parent / "smoke_soak"


def _soak_faults(chaos_dir):
    """Each faulted process's timed faults from its chaos artifact:
    {"<role>-<pid>": ["<fault>@t+<offset> fired at +<s>" or
    "<fault> expired:t+<offset>", ...]}, seconds from the epoch."""
    out = {}
    epoch_file = Path(chaos_dir).parent / "epoch"
    epoch = float(epoch_file.read_text()) if epoch_file.exists() else 0.0
    for path in sorted(Path(chaos_dir).glob("chaos-*.json")):
        art = json.loads(path.read_text())
        got = [f"{f['fault']}@t+{f['offset']:g} fired at "
               f"+{f['ts'] - epoch:.2f} s" for f in art["timed_fired"]]
        got += [f"{site.split('.', 1)[1]} {decision}"
                for site, _, decision in art["schedule"]
                if site.startswith("timed.") and "expired" in decision]
        out[f"{art['role']}-{art['pid']}"] = got
    return out


def phase_soak(budget_s=30.0, seed=3):
    """The port's soak (module docstring, phase 13): local mode with the
    assertions of `tests/test_soak.py::test_soak_smoke_local`, then
    cluster mode with the same assertions, its `kill@raylet` fired in a
    worker node's raylet and recovered on a node the autoscaler
    launched."""
    from ray_tpu_torch.soak import SoakConfig

    row = _run_soak(SoakConfig(budget_s=budget_s, mode="local", seed=seed,
                               workdir=str(SOAK_DIR), keep_workdir=True),
                    "soak")
    cluster = _run_soak(
        SoakConfig(budget_s=budget_s, mode="cluster", seed=seed,
                   fault_classes=("kill@raylet",), cluster_nodes=1,
                   cpus_per_node=2.0, autoscaler_interval_s=0.5,
                   workdir=str(SOAK_DIR), keep_workdir=True),
        "soak[cluster]")
    killed = [f for proc, fired in cluster["faults"].items()
              if proc.startswith("raylet-") for f in fired
              if f.startswith("kill@") and " fired " in f]
    assert len(killed) == 1, cluster["faults"]
    assert cluster["autoscaled_nodes"] >= 1, cluster
    print(f"soak[cluster]: `kill@raylet` fired in a worker node's raylet "
          f"({killed[0]}) and recovered in "
          f"{cluster['mttr_s']['kill@raylet']:.2f} s; the autoscaler "
          f"launched {cluster['autoscaled_nodes']} node(s)")
    row["cluster"] = cluster
    return row


def _run_soak(cfg, label):
    """One soak of `cfg` with the assertions of
    `tests/test_soak.py::test_soak_smoke_local`; its row."""
    from ray_tpu_torch._private import fault_injection as fi
    from ray_tpu_torch.soak import SoakDriver

    assert not _port_processes(), _port_processes()
    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    budget_s, seed = cfg.budget_s, cfg.seed
    n_faults = len(cfg.fault_classes) * cfg.faults_per_class
    t0 = time.perf_counter()
    try:
        res = SoakDriver(cfg).run()
        soak_s = time.perf_counter() - t0
        _assert_clean()
        faults = _soak_faults(SOAK_DIR / "chaos")
        print(f"{label}: the gang's first report "
              f"{res['first_report_s']:.2f} s after the soak's start; "
              f"faults by process {faults}")
        led = res["ledger"]
        assert led["faults_injected"] == n_faults, led
        assert set(led["mttr_by_class"]) == set(cfg.fault_classes), led
        assert led["recovered_count"] == n_faults, led
        assert all(m["mttr_s"] is not None and m["mttr_s"] > 0
                   for m in led["recoveries"]), led
        assert led["non_injected_failures"] == [], led
        assert led["failures_observed"] == led["injected_failures"] >= 1
        assert led["commits"] > 0 and led["restores"] >= 1, led
        assert led["resume_mismatches"] == [], led
        assert res["post_restore_checks"] >= 1, res
        assert res["watermark_checks"] > 0 and \
            res["watermark_errors"] == [], res
        assert res["final_step"] > 0 and res["steps_per_s"] > 0, res
        assert res["ingest_tokens_per_s"] > 0, res
        assert res["chaos_artifacts"], res
        for name in res["chaos_artifacts"]:
            with open(SOAK_DIR / "chaos" / name) as f:
                assert json.load(f)["spec"] == res["spec"]
        down = led["downtime_breakdown_s"]
        assert down["total_s"] >= down["dead_s"] >= 0, down
        for var in (fi.ENV_VAR, fi.LOG_ENV, fi.EPOCH_ENV, "RAY_TPU_TRACE"):
            assert os.environ.get(var) is None, var
    finally:
        shutil.rmtree(SOAK_DIR, ignore_errors=True)
    row = dict(mode=cfg.mode, soak_s=soak_s, spec=res["spec"],
               attempts=res["attempts"],
               first_report_s=res["first_report_s"], faults=faults,
               autoscaled_nodes=res.get("autoscaled_nodes"),
               final_step=res["final_step"],
               steps_per_s=res["steps_per_s"],
               ingest_tokens_per_s=res["ingest_tokens_per_s"],
               watermark_checks=res["watermark_checks"],
               mttr_s={m["fault_class"]: m["mttr_s"]
                       for m in led["recoveries"]},
               commits=led["commits"], restores=led["restores"])
    print(f"{label}: {cfg.mode} mode, {budget_s:.0f} s of running time "
          f"from the first report, seed "
          f"{seed}, {res['spec']}: {res['attempts']} restart(s), "
          f"{res['final_step']} steps at {res['steps_per_s']} steps/s on "
          f"the CPU, MTTR {row['mttr_s']}, {led['commits']} commits, "
          f"{led['restores']} restore(s), {res['watermark_checks']} "
          f"watermark checks, ledger clean; {soak_s:.2f} s in all")
    return row


CLUSTER_DIR = Path(__file__).resolve().parent / "smoke_cluster"
CLUSTER_IDLE_S = 5.0          # the autoscaler's idle timeout
CLUSTER_UPDATE_S = 0.5        # its reconcile interval
CLUSTER_JOB_TIMEOUT_S = 300   # the job (18 s on the H100): a GPU node's
                              # start, the GPU worker's, the engine's
                              # warm-up and capture, 8 requests
CLUSTER_WORKFLOW_ID = "smoke-gpt"

# The submitted job's driver (written to CLUSTER_DIR/job.py): a two-step
# workflow, the prompts on a CPU worker and GPT-2 on a num_gpus=1 worker,
# then a resume of the same id; one JSON line "CLUSTER_JOB {...}" last.
CLUSTER_JOB_SCRIPT = r'''
import json, os, sys, time

import ray_tpu_torch
from ray_tpu_torch import dag, workflow

with open(sys.argv[1]) as f:
    conf = json.load(f)


@ray_tpu_torch.remote(num_cpus=1)
def cpu_prompts(vocab_size, prompt_lens, seed):
    """The `gpt` engine phase's prompts (numpy, seed 1), the 3rd and 4th
    sharing a 64-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = list(rng.integers(1, vocab_size, 64))
    prompts = []
    for i, n in enumerate(prompt_lens):
        if i in (2, 3):
            prompts.append(shared + list(rng.integers(1, vocab_size,
                                                      n - 64)))
        else:
            prompts.append(list(rng.integers(1, vocab_size, n)))
    return [[int(x) for x in p] for p in prompts]


@ray_tpu_torch.remote(num_gpus=1)
def gpu_generate(prompts, model, seed, buckets, max_new, device):
    """GPT-2 from `seed` through `LLMEngine`, every bucket a CUDA graph,
    the prompts served at once; the flash kernel's launches counted from
    0 just before the requests and read just after."""
    t_entry = time.time()
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the GPU step sees no CUDA device")
    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_bwd)
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    ctx = ray_tpu_torch.get_runtime_context()
    cfg = getattr(gpt_mod.GPTConfig, model)()
    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = gpt_mod.init_params(cfg, gen, device=device)
    eng = LLMEngine(model="gpt", model_cfg=cfg, params=params,
                    device=device,
                    engine_config=EngineConfig(batch_buckets=(1, 2, 4, 8),
                                               prefill_buckets=buckets))
    eng.warmup()
    t_warm = time.time()
    eng.start()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    reqs = [eng.submit(p, max_new) for p in prompts]
    tokens = [r.result(timeout=600) for r in reqs]
    t_done = time.time()
    launches = [flash_attention.launches, flash_attention_bwd.launches]
    first = min(r.submit_wall + (r.first_token_ts - r.submit_ts)
                for r in reqs)
    prefills = sum(c for k, c in eng.metrics()["compiled_step_calls"].items()
                   if k.startswith("prefill:"))
    reserved = torch.cuda.memory_reserved() if device == "cuda" else 0
    eng.shutdown()
    return dict(tokens=tokens, launches=launches, prefills=prefills,
                n_layer=cfg.n_layer, node_id=ctx.get_node_id(),
                task_id=ctx.get_task_id(), pid=os.getpid(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                card=(torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu"),
                entry_wall=t_entry, imports_s=t0 - t_entry,
                engine_s=t_warm - t0, first_token_wall=first,
                gen_s=t_done - t_warm, reserved=reserved,
                end_wall=time.time())


ray_tpu_torch.init()
workflow.init(storage=conf["storage"])
graph = dag.bind(gpu_generate,
                 dag.bind(cpu_prompts, conf["vocab_size"],
                          conf["prompt_lens"], conf["seed"]),
                 conf["model"], conf["seed"], conf["buckets"],
                 conf["max_new"], conf["device"])
t0 = time.time()
out = workflow.run(graph, workflow_id=conf["workflow_id"])
run_s = time.time() - t0
t1 = time.time()
again = workflow.resume(conf["workflow_id"])
resume_s = time.time() - t1
meta = workflow.get_metadata(conf["workflow_id"])
ray_tpu_torch.shutdown()
print("CLUSTER_JOB " + json.dumps(dict(
    out, run_s=run_s, resume_s=resume_s, resume_equal=again == out,
    status=meta["status"], steps_checkpointed=meta["steps_checkpointed"])))
'''


class _CountingProvider:
    """`FakeMultiNodeProvider` with each launch and termination stamped
    (the autoscaler's decisions, as the phase reads them)."""

    def __init__(self, cluster):
        from ray_tpu_torch.autoscaler import FakeMultiNodeProvider

        self._inner = FakeMultiNodeProvider(cluster)
        self.launched, self.terminated = [], []

    def create_node(self, node_type):
        t0 = time.time()
        inst = self._inner.create_node(node_type)
        self.launched.append(dict(instance=inst, asked=t0,
                                  registered=time.time()))
        return inst

    def terminate_node(self, instance):
        t0 = time.time()
        self._inner.terminate_node(instance)
        self.terminated.append(dict(instance=instance, asked=t0,
                                    done=time.time()))

    def non_terminated_nodes(self):
        return self._inner.non_terminated_nodes()


def _node_alive(state, node_id):
    """Whether `state.list_nodes()` shows the node alive, with its GPU."""
    return any(n["NodeID"] == node_id and n["Alive"]
               and n["Resources"].get("GPU") == 1.0
               for n in state.list_nodes())


def phase_cluster(gpt, model="gpt2_125m", buckets=GPT_BUCKETS,
                  prompt_lens=GPT_PROMPT_LENS, max_new=32, seed=1,
                  store_bytes=SERVE_STORE_BYTES, device="cuda"):
    """The cluster tooling on the card (module docstring, phase 14): a
    job submitted to a cluster whose head has no GPU runs a workflow
    whose GPU step the autoscaler launches a GPU node for; the node
    retires once idle. `gpt` holds the `gpt` engine phase's tokens and
    top-2 gaps."""
    from ray_tpu_torch._private.node import Cluster
    from ray_tpu_torch.autoscaler import Autoscaler, NodeType
    from ray_tpu_torch.job_submission import SUCCEEDED, JobSubmissionClient
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.timeline import timeline

    card = card_line() if device == "cuda" else "cpu"
    cfg = getattr(gpt_mod.GPTConfig, model)()
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    assert not _port_processes(), _port_processes()
    free0 = _free_card_bytes(device)
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    CLUSTER_DIR.mkdir()
    script = CLUSTER_DIR / "job.py"
    script.write_text(CLUSTER_JOB_SCRIPT)
    conf = CLUSTER_DIR / "job.json"
    conf.write_text(json.dumps(dict(
        storage=str(CLUSTER_DIR / "wf"), workflow_id=CLUSTER_WORKFLOW_ID,
        vocab_size=cfg.vocab_size, prompt_lens=list(prompt_lens),
        seed=seed, model=model, buckets=list(buckets), max_new=max_new,
        device=device)))
    t_phase = time.perf_counter()
    # explicit head resources: no GPU detection, the head has no GPU
    cluster = Cluster(head_resources={"CPU": 2.0},
                      object_store_memory=store_bytes)
    autoscaler = None
    watch_stop = threading.Event()
    seen = dict(min_free=free0, alive_during=False)
    try:
        ray_tpu_torch.init(address=cluster.gcs_addr)
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
        provider = _CountingProvider(cluster)
        autoscaler = Autoscaler(
            cluster.gcs_addr, provider,
            [NodeType("gpu", {"CPU": 2.0, "GPU": 1.0})], max_workers=1,
            idle_timeout_s=CLUSTER_IDLE_S,
            update_interval_s=CLUSTER_UPDATE_S).start()
        client = JobSubmissionClient()
        t_submit = time.time()
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} {script} {conf}")

        def watch():
            # the card's memory and the GPU node's state while the job runs
            while not watch_stop.wait(0.1):
                seen["min_free"] = min(seen["min_free"],
                                       _free_card_bytes(device))
                if provider.launched and not seen["alive_during"]:
                    nid = provider.launched[0]["instance"].node_ids[0]
                    seen["alive_during"] = _node_alive(state, nid)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        status = client.wait_until_finished(job_id,
                                            timeout=CLUSTER_JOB_TIMEOUT_S)
        t_job_end = time.time()
        logs = client.get_job_logs(job_id)
        assert status == SUCCEEDED, (status, logs[-6000:])
        lines = [ln for ln in logs.splitlines()
                 if ln.startswith("CLUSTER_JOB ")]
        assert len(lines) == 1, logs[-6000:]
        res = json.loads(lines[0].split(" ", 1)[1])

        # the autoscaler launched one GPU node, and the step ran there
        assert len(provider.launched) == 1, provider.launched
        launch = provider.launched[0]
        inst = launch["instance"]
        assert inst.node_type == "gpu" and len(inst.node_ids) == 1
        gpu_node = inst.node_ids[0]
        assert res["node_id"] == gpu_node, (res["node_id"], gpu_node)
        assert seen["alive_during"], "the GPU node never showed alive"
        if device == "cuda":
            assert res["visible"] not in (None, ""), res["visible"]
            assert res["card"] == torch.cuda.get_device_name(0)
        # GPT-2's tokens equal the in-process `gpt` phase's
        assert all(len(t) == max_new for t in res["tokens"])
        compared, ties = _near_tie_compare(res["tokens"], gpt["tokens"],
                                           gpt["gaps"], "cluster")
        fwd, bwd = res["launches"]
        assert bwd == 0, bwd
        if device == "cuda":
            assert fwd == res["n_layer"] * res["prefills"] > 0, (
                fwd, res["prefills"])
        # the resume ran nothing: one finished task of each step
        assert res["resume_equal"] and res["status"] == "SUCCEEDED", res
        deadline = time.monotonic() + 20
        while True:
            gpu_tasks = state.list_tasks(name="gpu_generate")
            cpu_tasks = state.list_tasks(name="cpu_prompts")
            if [t["state"] for t in gpu_tasks] == ["FINISHED"] and \
                    [t["state"] for t in cpu_tasks] == ["FINISHED"] or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert [t["state"] for t in gpu_tasks] == ["FINISHED"], gpu_tasks
        assert [t["state"] for t in cpu_tasks] == ["FINISHED"], cpu_tasks
        assert gpu_tasks[0]["task_id"] == res["task_id"]
        # the timeline holds the GPU step's event, that task on that node
        events = [e for e in timeline()
                  if e["args"]["task_id"] == res["task_id"]]
        assert len(events) == 1 and events[0]["name"] == "gpu_generate" \
            and events[0]["ph"] == "X", events

        # idle past the timeout: the autoscaler retires the node, and the
        # card's memory comes back
        deadline = time.monotonic() + 60
        while not provider.terminated and time.monotonic() < deadline:
            time.sleep(0.1)
        assert provider.terminated, "the idle GPU node was never retired"
        term = provider.terminated[0]
        assert term["instance"].instance_id == inst.instance_id
        deadline = time.monotonic() + 30
        while _node_alive(state, gpu_node) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not _node_alive(state, gpu_node)
        assert any(n["NodeID"] == gpu_node and not n["Alive"]
                   for n in state.list_nodes())
        free_back, back_s = _wait_free(device, free0 - SERVE_MEM_SLACK, 60)
        if device == "cuda":
            assert free_back >= free0 - SERVE_MEM_SLACK, (free0, free_back)
    finally:
        watch_stop.set()
        if autoscaler is not None:
            autoscaler.stop()
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    _assert_clean()
    phase_s = time.perf_counter() - t_phase
    row = dict(
        submit_to_node_s=launch["registered"] - t_submit,
        node_start_s=launch["registered"] - launch["asked"],
        node_to_first_token_s=res["first_token_wall"] - launch["registered"],
        step_imports_s=res["imports_s"], step_engine_s=res["engine_s"],
        step_gen_s=res["gen_s"],
        job_s=t_job_end - t_submit, workflow_run_s=res["run_s"],
        resume_s=res["resume_s"],
        idle_to_terminated_s=term["done"] - res["end_wall"],
        terminate_s=term["done"] - term["asked"],
        free_before=free0, free_min_during=seen["min_free"],
        free_after=free_back, free_back_s=back_s,
        worker_reserved=res["reserved"], launches=fwd,
        prefills=res["prefills"], compared_tokens=compared,
        near_ties=ties, phase_s=phase_s)
    print(f"cluster: job {job_id} SUCCEEDED in {row['job_s']:.2f} s from "
          f"the submit; the autoscaler launched 1 `gpu` node "
          f"({{'CPU': 2, 'GPU': 1}}) {row['submit_to_node_s']:.2f} s after "
          f"the submit (its raylet up in {row['node_start_s']:.2f} s); the "
          f"GPU step's first token {row['node_to_first_token_s']:.2f} s "
          f"after the node registered (the step: imports "
          f"{row['step_imports_s']:.2f} s, weights + warm-up and capture "
          f"{row['step_engine_s']:.2f} s, 8 requests x {max_new} tokens "
          f"{row['step_gen_s']:.2f} s); workflow.run {row['workflow_run_s']:.2f}"
          f" s, the resume {row['resume_s']:.3f} s (no task); flash launches"
          f" in the GPU worker {fwd} = {res['n_layer']} x {res['prefills']} "
          f"prefills; tokens equal to the `gpt` phase's: {compared} "
          f"compared, {len(ties)} near-tie stop(s); the node retired "
          f"{row['idle_to_terminated_s']:.2f} s after the step ended "
          f"(idle timeout {CLUSTER_IDLE_S:.0f} s; the termination "
          f"{row['terminate_s']:.2f} s); the card's free memory "
          f"{free0 / 2**30:.2f} GiB before, {seen['min_free'] / 2**30:.2f} "
          f"at its least during the job, {free_back / 2**30:.2f} after "
          f"({back_s:.2f} s after the termination); no process or segment "
          f"left; {phase_s:.1f} s in all (card: {card})")
    return row


OPERATOR_DIR = Path(__file__).resolve().parent / "smoke_operator"
OPERATOR_PUT_BYTES = 64 << 20        # the client's CUDA tensor
OPERATOR_QKV = (1, 1024, 12, 64)     # the client task's kernel: GPT-2's
                                     # prefill shape (B, T, H, D), bf16
OPERATOR_VERB_TIMEOUT_S = 600        # any one verb; `serve-deploy` waits
                                     # for nothing but the controller
OPERATOR_READY_TIMEOUT_S = 120       # a long-running verb's ready line
OPERATOR_ROUTES = (
    "/", "/api/nodes", "/api/actors", "/api/tasks", "/api/objects",
    "/api/task_summary", "/api/timeline", "/api/cluster_resources",
    "/api/cluster_load", "/api/jobs", "/api/events", "/api/steps",
    "/api/serve_llm", "/api/timeseries", "/api/alerts", "/api/requests",
    "/api/recovery")

# The `client://` driver (OPERATOR_DIR/client_driver.py): a 64 MiB CUDA
# tensor put and got back, an actor, and a num_gpus=1 task that holds the
# forward kernel against its plain version; one JSON line last.
OPERATOR_CLIENT_SCRIPT = r'''
import json, os, sys, time

import torch

import ray_tpu_torch

addr, conf = sys.argv[1], json.loads(sys.argv[2])
device = conf["device"]


@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


@ray_tpu_torch.remote(num_gpus=1)
def flash_task(shape, seed, device):
    """The forward kernel at `shape` (bf16, causal) against its plain
    version in a GPU worker; the launch count is 0 just before the
    kernel's call and read just after it."""
    import torch

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    if device == "cuda":
        _build.load("flash_attention_fwd")  # the smoke's build, no nvcc
    b, t, h, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        flash_attention.launches = 0
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        launches = flash_attention.launches
        ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    return dict(err=float((out.float() - ref.float()).abs().max()),
                lse_err=float((lse - ref_lse).abs().max()),
                finite=bool(torch.isfinite(out.float()).all()),
                launches=launches,
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                card=(torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu"))


t0 = time.perf_counter()
ray_tpu_torch.init(address=f"client://{addr}")
connect_s = time.perf_counter() - t0
gen = torch.Generator(device=device).manual_seed(conf["seed"])
x = torch.randn(conf["put_bytes"] // 4, generator=gen, device=device)
t1 = time.perf_counter()
ref = ray_tpu_torch.put(x)
put_s = time.perf_counter() - t1
back = ray_tpu_torch.get(ref)
get_s = time.perf_counter() - t1 - put_s
same = back.device.type == x.device.type and torch.equal(back, x)
counter = Counter.remote()
actor = [ray_tpu_torch.get(counter.add.remote(k)) for k in (1, 2, 3)]
t2 = time.perf_counter()
task = ray_tpu_torch.get(flash_task.remote(conf["qkv"], conf["seed"],
                                           device), timeout=600)
task_s = time.perf_counter() - t2
ray_tpu_torch.kill(counter)
ray_tpu_torch.shutdown()  # the client's disconnect
print("OPERATOR_CLIENT " + json.dumps(dict(
    connect_s=connect_s, put_s=put_s, get_s=get_s, same=same,
    device=back.device.type, nbytes=x.nbytes, actor=actor, task=task,
    task_s=task_s)))
'''

# The applications `serve-deploy` imports (OPERATOR_DIR/operator_apps.py,
# on the CLI's and the workers' PYTHONPATH): GPT-2 on a num_gpus=1
# replica, and a plain deployment on /echo. No torch at module level:
# the CLI and the controller import it without torch.
OPERATOR_APPS = r'''
from ray_tpu_torch import serve

CONF = {conf}

llm = serve.llm.build_app(
    name="llm", model="gpt", model_config=CONF["model_config"],
    engine_config=dict(batch_buckets=[1, 2, 4, 8],
                       prefill_buckets=CONF["buckets"]),
    seed=CONF["seed"], device=CONF["device"],
    **({{}} if CONF["device"] == "cuda" else
       {{"ray_actor_options": {{"num_gpus": 1}}}}))


@serve.deployment
def echo(body=None):
    return {{"echo": body}}


echo_app = echo.bind()
'''

# The driver that joins by address (OPERATOR_DIR/serve_driver.py): the
# `gpt` phase's prompts as concurrent streams through
# `get_deployment_handle("llm")`, the replica's kernel launches counted
# from 0 just before and read just after; then HTTP to /echo and to an
# unknown route through the proxy. Imports no torch.
OPERATOR_SERVE_SCRIPT = r'''
import json, sys, threading, time, urllib.error, urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve

conf = json.loads(sys.argv[1])
ray_tpu_torch.init(address=conf["gcs"])
handle = serve.get_deployment_handle("llm")
m0 = handle.engine_metrics.remote().result(timeout=900)  # the replica is up
up_wall = time.time()
handle.kernel_launches.remote(reset=True).result(timeout=60)
outs = [[] for _ in conf["prompts"]]
firsts = [None] * len(outs)
errors = []
t0 = time.perf_counter()
gens = [handle.generate.options(stream=True).remote(p, conf["max_new"])
        for p in conf["prompts"]]


def read(i):
    try:
        for chunk in gens[i]:
            if firsts[i] is None:
                firsts[i] = time.time()
            outs[i].append(chunk["token"])
    except BaseException as e:  # noqa: BLE001 — raised below
        errors.append(repr(e))


threads = [threading.Thread(target=read, args=(i,)) for i in range(len(gens))]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=600)
gen_s = time.perf_counter() - t0
assert not errors, errors
launches = handle.kernel_launches.remote().result(timeout=60)
m1 = handle.engine_metrics.remote().result(timeout=60)
prefills = sum(c - m0["compiled_step_calls"].get(k, 0)
               for k, c in m1["compiled_step_calls"].items()
               if k.startswith("prefill:"))
base = f"http://127.0.0.1:{conf['http_port']}"
req = urllib.request.Request(base + "/echo", data=b'{"k": [1, 2]}')
with urllib.request.urlopen(req, timeout=60) as r:
    echo = [r.status, r.headers["Content-Type"], json.loads(r.read())]
try:
    urllib.request.urlopen(base + "/nope", timeout=60)
    unknown = None
except urllib.error.HTTPError as e:
    unknown = [e.code, json.loads(e.read())]
ray_tpu_torch.shutdown()
print("OPERATOR_SERVE " + json.dumps(dict(
    tokens=outs, first_token_wall=min(firsts), up_wall=up_wall,
    gen_s=gen_s, launches=launches, prefills=prefills, echo=echo,
    unknown=unknown, kv_pages_total=m1["kv_pages_total"])))
'''


def _operator_processes():
    """Live processes the operator phase started outside the runtime's
    daemons: the CLI's verbs (`-m ray_tpu_torch ...`) and its drivers
    (scripts under OPERATOR_DIR)."""
    return _port_processes((b"-m\x00ray_tpu_torch\x00",
                            str(OPERATOR_DIR).encode()))


def _verb(args, env, timeout=OPERATOR_VERB_TIMEOUT_S):
    """`python -m ray_tpu_torch <args>` to its end; a non-zero exit
    raises with its output. Returns (stdout, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                         env=env, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(
            f"`ray_tpu_torch {' '.join(args)}` exited {out.returncode}:\n"
            f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, seconds


def _script(name, text, argv, env, prefix, timeout=OPERATOR_VERB_TIMEOUT_S):
    """Runs OPERATOR_DIR/<name> (written from `text`) to its end; returns
    the JSON of its `<prefix> {...}` line and its seconds."""
    path = OPERATOR_DIR / name
    path.write_text(text)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(path), *argv], env=env,
                         cwd=OPERATOR_DIR, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(prefix + " ")]
    if out.returncode != 0 or len(lines) != 1:
        raise AssertionError(
            f"{name} exited {out.returncode}:\n{out.stdout[-3000:]}\n"
            f"{out.stderr[-4000:]}")
    return json.loads(lines[0].split(" ", 1)[1]), seconds


def _start_verb(args, env, ready_prefix, log_name):
    """Starts a long-running verb (`client-server`, `dashboard`) and
    waits for its ready line; returns (the process, the line, seconds)."""
    import queue

    t0 = time.perf_counter()
    log = open(OPERATOR_DIR / log_name, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", *args], env=env,
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=log, text=True)
    log.close()
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.monotonic() + OPERATOR_READY_TIMEOUT_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=0.2)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        if line.startswith(ready_prefix):
            return proc, line.strip(), time.perf_counter() - t0
    proc.kill()
    raise AssertionError(
        f"`ray_tpu_torch {' '.join(args)}` printed no {ready_prefix!r} "
        f"(exit {proc.poll()}):\n"
        + (OPERATOR_DIR / log_name).read_text()[-4000:])


def _stop_verb(proc, name):
    """SIGTERM, as an operator's ^C or a service manager ends it; the
    verb must be gone within 30 s."""
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"`{name}` outlived SIGTERM by 30 s")


def _fetch(url):
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as r:
        status, ctype, body = r.status, r.headers["Content-Type"], r.read()
    return status, ctype, body, (time.perf_counter() - t0) * 1e3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_operator(gpt, model="gpt2_125m", buckets=GPT_BUCKETS,
                   prompt_lens=GPT_PROMPT_LENS, max_new=32, seed=1,
                   qkv=OPERATOR_QKV, put_bytes=OPERATOR_PUT_BYTES,
                   store_bytes=SERVE_STORE_BYTES, device="cuda"):
    """The operator surface on the card (module docstring, phase 15):
    every verb a subprocess `python -m ray_tpu_torch ...` as an operator
    runs it. `gpt` holds the `gpt` engine phase's tokens and top-2 gaps.
    On the CPU (`device="cpu"`) the head's GPU is faked
    (RAY_TPU_GPU_COUNT=1) and the kernels run their plain versions."""
    from ray_tpu_torch.autoscaler import gcp_tpu

    card = card_line() if device == "cuda" else "cpu"
    cfg = getattr(gpt_mod.GPTConfig, model)()
    prompts = _prompts(cfg, prompt_lens, seed)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    assert not _port_processes(), _port_processes()
    assert not _operator_processes(), _operator_processes()
    free0 = _free_card_bytes(device)
    shutil.rmtree(OPERATOR_DIR, ignore_errors=True)
    OPERATOR_DIR.mkdir()
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    env.pop("PYTHONUNBUFFERED", None)  # ready lines must be flushed
    env["PYTHONPATH"] = os.pathsep.join([str(OPERATOR_DIR), str(root)])
    env["RAY_TPU_TORCH_CLI_STATE_FILE"] = str(OPERATOR_DIR / "head.json")
    # request records from the replica and the drivers go to shards the
    # dashboard's process merges
    env["RAY_TPU_TRACE"] = "1"
    env["RAY_TPU_TRACE_DIR"] = str(OPERATOR_DIR / "traces")
    if device != "cuda":
        env["RAY_TPU_GPU_COUNT"] = "1"
    else:
        env.pop("RAY_TPU_GPU_COUNT", None)
    env_node = dict(env, RAY_TPU_TORCH_CLI_STATE_FILE=str(
        OPERATOR_DIR / "node.json"))
    verbs = {}
    started = []   # long-running verbs, for the cleanup
    stops = []     # state files of nodes to `stop`
    t_phase = time.perf_counter()
    try:
        # 1. the head (no --resources: it detects the card) and a
        # CPU-only node joined by the autoscaler's bootstrap command line
        out, verbs["start --head"] = _verb(
            ["start", "--head", "--port", str(_free_port()),
             "--object-store-memory", str(store_bytes)], env)
        stops.append(env)
        gcs = json.loads((OPERATOR_DIR / "head.json").read_text())["gcs_addr"]
        assert f"GCS started at {gcs}" in out, out
        boot = gcp_tpu.bootstrap_script(gcs, "smoke-operator-1")
        line = [ln for ln in boot.splitlines()
                if "ray_tpu_torch.scripts.cli start" in ln]
        assert len(line) == 1, boot
        join = line[0].replace("python ", f"{sys.executable} ", 1) + \
            """ --resources '{"CPU": 2}'"""
        t0 = time.perf_counter()
        joined = subprocess.run(["bash", "-c", join], env=env_node, cwd=root,
                                capture_output=True, text=True,
                                timeout=OPERATOR_VERB_TIMEOUT_S)
        verbs["start --address (bootstrap)"] = time.perf_counter() - t0
        assert joined.returncode == 0, joined.stderr[-3000:]
        stops.append(env_node)
        status, verbs["status"] = _verb(["status", "--address", gcs], env)
        assert "2 alive node(s)" in status, status
        head_line = [ln for ln in status.splitlines() if " + " in ln
                     and "'GPU': 1.0" in ln]
        assert len(head_line) == 1, status  # the head, with the card
        assert "resources: total={" in status and "'GPU': 1.0" in \
            status.split("resources:")[1], status

        # 2. a client:// driver through the client server
        server, ready, verbs["client-server (ready)"] = _start_verb(
            ["client-server", "--address", gcs, "--port", "0"], env,
            "CLIENT_SERVER_READY", "client_server.log")
        started.append((server, "client-server"))
        client, client_s = _script(
            "client_driver.py", OPERATOR_CLIENT_SCRIPT,
            [ready.split()[1], json.dumps(dict(
                device=device, seed=seed, put_bytes=put_bytes,
                qkv=list(qkv)))], env, "OPERATOR_CLIENT")
        assert client["same"] and client["device"] == (
            "cuda" if device == "cuda" else "cpu"), client
        assert client["nbytes"] == put_bytes and client["actor"] == [1, 3, 6]
        task = client["task"]
        tol_o, tol_lse = TOL[torch.bfloat16]
        assert task["finite"] and task["err"] <= tol_o and \
            task["lse_err"] <= tol_lse, task
        if device == "cuda":
            assert task["launches"] == 1, task
            assert task["visible"] not in (None, "") and \
                task["card"] == torch.cuda.get_device_name(0), task

        # 3. serve-deploy: GPT-2 on a GPU replica, a plain app on /echo
        http_port = _free_port()
        (OPERATOR_DIR / "operator_apps.py").write_text(
            OPERATOR_APPS.format(conf=repr(dict(
                model_config=_model_config(cfg), buckets=list(buckets),
                seed=seed, device=device))))
        (OPERATOR_DIR / "serve.yaml").write_text(
            f"http_options:\n  port: {http_port}\n"
            "applications:\n"
            "  - name: llm\n"
            "    import_path: operator_apps:llm\n"
            "    route_prefix: null\n"
            "  - name: echo\n"
            "    import_path: operator_apps:echo_app\n"
            "    route_prefix: /echo\n")
        t_deploy = time.time()
        out, verbs["serve-deploy"] = _verb(
            ["serve-deploy", str(OPERATOR_DIR / "serve.yaml"),
             "--address", gcs], env)
        assert "deployed applications: llm, echo" in out, out
        served, serve_s = _script(
            "serve_driver.py", OPERATOR_SERVE_SCRIPT,
            [json.dumps(dict(gcs=gcs, prompts=prompts, max_new=max_new,
                             http_port=http_port))], env, "OPERATOR_SERVE")
        assert all(len(t) == max_new for t in served["tokens"])
        compared, ties = _near_tie_compare(served["tokens"], gpt["tokens"],
                                           gpt["gaps"], "operator")
        fwd = served["launches"]["flash_attention"]
        assert served["launches"]["flash_attention_bwd"] == 0, served
        if device == "cuda":
            assert fwd == cfg.n_layer * served["prefills"] > 0, (
                fwd, served["prefills"])
        assert served["echo"] == [200, "application/json; charset=utf-8",
                                  {"echo": {"k": [1, 2]}}], served["echo"]
        assert served["unknown"] == [404, {"error": "no route for /nope"}], \
            served["unknown"]

        # 4. the dashboard in its own process: every route
        dash_port = _free_port()
        dash, _, verbs["dashboard (ready)"] = _start_verb(
            ["dashboard", "--address", gcs, "--port", str(dash_port)], env,
            "dashboard at", "dashboard.log")
        started.append((dash, "dashboard"))
        route_ms, panels = {}, {}
        for route in OPERATOR_ROUTES:
            st, ctype, body, ms = _fetch(f"http://127.0.0.1:{dash_port}"
                                         f"{route}")
            assert st == 200, (route, st)
            route_ms[route] = ms
            if route == "/":
                assert ctype == "text/html; charset=utf-8" and \
                    b"ray_tpu_torch dashboard" in body, ctype
            else:
                assert ctype == "application/json; charset=utf-8", ctype
                panels[route] = json.loads(body)
        assert any(n["Alive"] and n["Resources"].get("GPU") == 1.0
                   for n in panels["/api/nodes"]), panels["/api/nodes"]
        assert sum(n["Alive"] for n in panels["/api/nodes"]) == 2
        assert any(a["class_name"] == "Replica" and a["state"] == "ALIVE"
                   for a in panels["/api/actors"]), panels["/api/actors"]
        llm_rows = [d for d in panels["/api/serve_llm"]["deployments"]
                    if d["deployment"] == "llm"]
        assert len(llm_rows) == 1 and \
            llm_rows[0]["replicas"][0]["kv_pages_total"] > 0, panels[
                "/api/serve_llm"]
        streamed = [r for r in panels["/api/requests"]["records"]
                    if r.get("deployment") == "llm"
                    and r.get("tokens_out") == max_new]
        assert len(streamed) == len(prompts), panels["/api/requests"]

        # 5. the inspection verbs
        out, verbs["list actors"] = _verb(["list", "actors", "--address",
                                           gcs], env)
        assert any(json.loads(ln)["class_name"] == "Replica" and
                   json.loads(ln)["state"] == "ALIVE"
                   for ln in out.splitlines()), out
        out, verbs["summary"] = _verb(["summary", "--address", gcs], env)
        assert "flash_task: " in out, out
        out, verbs["memory"] = _verb(["memory", "--address", gcs], env)
        assert "primary copies" in out, out
        tl = OPERATOR_DIR / "timeline.json"
        out, verbs["timeline"] = _verb(["timeline", "--address", gcs,
                                        "--output", str(tl)], env)
        assert any(e["name"] == "flash_task"
                   for e in json.loads(tl.read_text())), out
        out, verbs["stack --json"] = _verb(["stack", "--json",
                                            "--address", gcs], env)
        reports = json.loads(out)
        assert not [r for r in reports if r.get("error")], reports
        roles = sorted(r["role"] for r in reports)
        assert roles == ["cli", "gcs", "raylet", "raylet"], roles
        out, verbs["alerts"] = _verb(["alerts", "--scrapes", "2",
                                      "--interval", "1", "--json",
                                      "--address", gcs], env)
        alerts = json.loads(out)
        assert alerts["alerts"] and alerts["evaluations"] >= 2, alerts
        out, verbs["top"] = _verb(["top", "--iterations", "2",
                                   "--interval", "1", "--no-clear",
                                   "--address", gcs], env)
        kv = re.findall(r"deployment llm: 1 replicas .* kv=(\d+)/(\d+) "
                        r"pages", out)
        assert len(kv) == 2 and int(kv[-1][1]) == served[
            "kv_pages_total"] > 0, out
        (OPERATOR_DIR / "job.py").write_text(
            "print('operator job ok')\n")
        out, verbs["job submit --wait"] = _verb(
            # the entrypoint next to `submit`: the card host's Python
            # 3.12.3 argparse takes it nowhere after the options
            ["job", "submit", sys.executable, str(OPERATOR_DIR / "job.py"),
             "--wait", "--address", gcs], env)
        assert "SUCCEEDED" in out and "operator job ok" in out, out

        # 6. serve shutdown, the long-running verbs ended, both nodes
        # stopped
        out, verbs["serve shutdown"] = _verb(["serve", "shutdown",
                                              "--address", gcs], env)
        assert "serve instance shut down" in out, out
    finally:
        for proc, name in reversed(started):
            _stop_verb(proc, name)
        for node_env in reversed(stops):
            _verb(["stop"], node_env)
    _assert_clean()
    deadline = time.monotonic() + 30
    while _operator_processes() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not _operator_processes(), _operator_processes()
    free_back, back_s = _wait_free(device, free0 - SERVE_MEM_SLACK, 60)
    if device == "cuda":
        assert free_back >= free0 - SERVE_MEM_SLACK, (free0, free_back)
    shutil.rmtree(OPERATOR_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    tokens = len(prompts) * max_new
    row = dict(
        verbs_s=verbs, head_start_s=verbs["start --head"],
        join_s=verbs["start --address (bootstrap)"],
        client_connect_s=client["connect_s"], client_put_s=client["put_s"],
        client_get_s=client["get_s"], client_task_s=client["task_s"],
        client_err=task["err"], client_lse_err=task["lse_err"],
        client_launches=task["launches"], client_script_s=client_s,
        deploy_to_first_token_s=served["first_token_wall"] - t_deploy,
        deploy_to_replica_up_s=served["up_wall"] - t_deploy,
        tokens_per_s=tokens / served["gen_s"], gen_s=served["gen_s"],
        serve_script_s=serve_s, launches=fwd,
        prefills=served["prefills"], compared_tokens=compared,
        near_ties=ties, dashboard_ms=route_ms,
        stack_s=verbs["stack --json"], free_before=free0,
        free_after=free_back, free_back_s=back_s, phase_s=phase_s)
    print(f"operator: `start --head` {row['head_start_s']:.2f} s (GPU 1.0 "
          f"detected), the node joined by the bootstrap line in "
          f"{row['join_s']:.2f} s; client:// put+get of a "
          f"{put_bytes >> 20} MiB {client['device']} tensor "
          f"{client['put_s']:.3f}+{client['get_s']:.3f} s, the num_gpus=1 "
          f"kernel task {row['client_task_s']:.2f} s (O err "
          f"{task['err']:.2e}, lse err {task['lse_err']:.2e}, "
          f"{task['launches']} launch); `serve-deploy` "
          f"{verbs['serve-deploy']:.2f} s, the replica up "
          f"{row['deploy_to_replica_up_s']:.2f} s and the first token "
          f"{row['deploy_to_first_token_s']:.2f} s after the deploy began; "
          f"8 streams x {max_new} tokens in {served['gen_s']:.3f} s = "
          f"{row['tokens_per_s']:.1f} tok/s; flash launches in the replica "
          f"{fwd} = {cfg.n_layer} x {served['prefills']} prefills; tokens "
          f"equal to the `gpt` phase's: {compared} compared, {len(ties)} "
          f"near-tie stop(s); HTTP /echo 200, /nope 404 through the "
          f"proxy; `stack` {row['stack_s']:.2f} s; no process or segment "
          f"left, the card's free memory {free0 / 2**30:.2f} GiB before, "
          f"{free_back / 2**30:.2f} after; {phase_s:.1f} s in all "
          f"(card: {card})")
    print("operator: dashboard ms " + ", ".join(
        f"{r} {ms:.1f}" for r, ms in route_ms.items()))
    print("operator: verbs s " + ", ".join(
        f"{v} {s:.2f}" for v, s in verbs.items()))
    return row


PARALLEL_DIR = Path(__file__).resolve().parent / "smoke_parallel"
PARALLEL_K1_STEPS = 6      # steps at K=1, then K=4 calls: 14 steps in all
PARALLEL_K4_CALLS = 2
PARALLEL_PAIR_STEPS = 3    # eager steps of each two-rank gloo run
# a step split over more than one rank (tp or fsdp: bf16 partial sums in
# another order) against one rank's losses
PARALLEL_SPLIT_LOSS_RTOL = 5e-3
PARALLEL_PAIRS = ({"tp": 2}, {"fsdp": 2})  # the two-rank gloo runs


def _pick_strategy(n_devices):
    """`__graft_entry__._pick_strategy` (the JAX package's multi-device
    dry run): factors of two peeled onto fsdp, tp, sp; the rest is dp, so
    1 -> every axis 1, 4 -> fsdp=2 tp=2, 8 -> fsdp=2 tp=2 sp=2."""
    from ray_tpu_torch.parallel import ShardingStrategy

    axes = {"fsdp": 1, "tp": 1, "sp": 1}
    rem = n_devices
    for name in ("fsdp", "tp", "sp"):
        if rem % 2 == 0:
            axes[name] = 2
            rem //= 2
    return ShardingStrategy(dp=rem, **axes)


def _sharded_setup(strategy, model, seed, batch, seq, device, capturable):
    """The `train` phase's GPT-2 (same seed, weights and batch) placed on
    `strategy`'s mesh over the process group: the parameters by
    `param_shardings` (this rank's shards), the batch by `shard_batch`
    (this rank's block), AdamW over the shards and the sharded step."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import logical_axis_rules, shard_batch
    from ray_tpu_torch.parallel.sharding import param_shardings, shard_params

    mesh = strategy.build_mesh(device=device)
    cfg = getattr(gpt_mod.GPTConfig, model)(remat=False, max_seq_len=seq)
    shardings = param_shardings(mesh, gpt_mod.param_logical_axes(cfg),
                                logical_axis_rules(strategy))
    gen = torch.Generator(device=device).manual_seed(seed)
    full = gpt_mod.init_params(cfg, gen, device=device, dtype=torch.float32)
    net = gpt_mod.GPT.from_params(
        cfg, shard_params(full, mesh, shardings),
        attention_fn=partial(flash_attention, causal=True), trainable=True)
    del full
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq + 1))
    data = {k: v.to_local() for k, v in shard_batch(
        {"x": toks[:, :-1], "y": toks[:, 1:]}, mesh, strategy).items()}
    opt = torch.optim.AdamW(net.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4,
                            capturable=capturable)
    carry = _adamw_carry(net, opt)
    params = carry["params"]

    def train_step(carry, data):
        loss = gpt_mod.sharded_loss(net, data["x"], data["y"], mesh,
                                    shardings)
        loss.backward()
        gpt_mod.reduce_gradients(params, mesh, shardings)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, gpt_mod.global_loss(loss, mesh)

    local = {n: tuple(p.shape) for n, p in params.items()
             if n in ("wte", "h0.attn_qkv.weight", "h0.mlp_down.weight")}
    return dict(mesh=mesh, cfg=cfg, carry=carry, data=data, step=train_step,
                local_shapes=local, backend=dist.get_backend(),
                world=dist.get_world_size(), rank=dist.get_rank())


def _parallel_loop(config):
    """`parallel`'s training loop, in each `TorchTrainer` GPU worker; it
    imports this script there (see `_dist_loop`)."""
    import chip_smoke

    chip_smoke._parallel_worker(config)


def _parallel_worker(config):
    """One rank of phase 16 (a): `_pick_strategy(world)`'s mesh over the
    gang's NCCL group, the sharded step through `TrainStepRunner(mesh=)`
    at K=1 for 6 steps, then K=4 twice; one report at the end."""
    from ray_tpu_torch import train

    device = config["device"]
    strategy = _pick_strategy(torch.distributed.get_world_size())
    t0 = time.perf_counter()
    s = _sharded_setup(strategy, config["model"], config["seed"],
                       config["batch"], config["seq"], device,
                       capturable=device == "cuda")
    setup_s = time.perf_counter() - t0
    cfg, mesh, carry = s["cfg"], s["mesh"], s["carry"]
    tokens = config["batch"] * config["seq"]
    flops = gpt_mod.flops_per_token(cfg, config["seq"]) * tokens
    runs, losses = [], []
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    for k, calls in ((1, PARALLEL_K1_STEPS), (4, PARALLEL_K4_CALLS)):
        runner = TrainStepRunner(
            s["step"], steps_per_call=k, mesh=mesh, tokens_per_step=tokens,
            flops_per_step=flops, peak_flops=PEAK_BF16_FLOPS, device=device)
        batches = s["data"] if k == 1 else stack_batches([s["data"]] * k)
        reserved0 = torch.cuda.memory_reserved() if device == "cuda" else 0
        stats0 = runner.cache_stats()
        for i in range(calls):
            t0 = time.perf_counter()
            carry, loss = runner.run(carry, batches)
            if device == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            losses.extend(float(x) for x in loss.reshape(-1).tolist())
            if i == 0 and device == "cuda":
                torch.cuda.empty_cache()
                pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30
            runs.append(dict(k=k, miss=i == 0, ms=ms,
                             pool_gib=pool_gib if device == "cuda" else 0.0))
        # this runner's share of the process's cache counters
        runs[-1]["cache"] = {key: n - stats0[key] for key, n in
                             runner.cache_stats().items()}
        global_cache().evict(runner._compiled)
        del runner, batches
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    train.report(dict(
        losses=losses, runs=runs, fwd_launches=fwd, bwd_launches=bwd,
        steps=len(losses), setup_s=setup_s, mesh=mesh.shape,
        local_shapes=s["local_shapes"], backend=s["backend"],
        world=s["world"], rank=s["rank"],
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                  if device == "cuda" else 0.0)))


def _parallel_pair_rank(config_json):
    """One rank of the two-rank gloo runs on the one card (phase 16 (b)):
    for each mesh of `config["axes"]`, `PARALLEL_PAIR_STEPS` eager sharded
    steps (gloo collectives cannot be captured into a graph); the losses
    and times to `out`."""
    config = json.loads(config_json)
    from ray_tpu_torch.parallel import ShardingStrategy

    device = config["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{config['store']}",
        world_size=2, rank=config["rank"])
    rows = []
    try:
        for axes in config["axes"]:
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            s = _sharded_setup(ShardingStrategy(**axes), config["model"],
                               config["seed"], config["batch"],
                               config["seq"], device, capturable=False)
            carry, losses, ms = s["carry"], [], []
            # this run's main path: counts at 0 just before, read after
            flash_attention.launches = 0
            flash_attention_bwd.launches = 0
            for _ in range(PARALLEL_PAIR_STEPS):
                t0 = time.perf_counter()
                carry, loss = s["step"](carry, s["data"])
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(dict(
                axes=axes, losses=losses, step_ms=ms, mesh=s["mesh"].shape,
                local_shapes=s["local_shapes"], backend=s["backend"],
                fwd_launches=flash_attention.launches,
                bwd_launches=flash_attention_bwd.launches,
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                          if device == "cuda" else 0.0)))
            del s, carry
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    with open(f"{config['out']}.{config['rank']}.json", "w") as f:
        json.dump(rows, f)


def _parallel_pair(axes, model, seed, batch, seq, device, timeout=600):
    """Two processes on the one card, one gloo group, each of the meshes
    `axes` in turn; per mesh, both ranks' rows."""
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir()
    out = str(PARALLEL_DIR / "pair")
    procs = []
    for rank in range(2):
        config = dict(rank=rank, axes=list(axes), model=model, seed=seed,
                      batch=batch, seq=seq, device=device, out=out,
                      store=str(PARALLEL_DIR / "store"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke._parallel_pair_rank(sys.argv[1])",
             json.dumps(config)], cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs))
    by_rank = []
    for rank in range(2):
        with open(f"{out}.{rank}.json") as f:
            by_rank.append(json.load(f))
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    return [list(rows) for rows in zip(*by_rank)], wall_s


def phase_parallel(want_losses, ref_ms, model="gpt2_125m", batch=16,
                   seq=1024, seed=3, device="cuda"):
    """Phase 16 (module docstring): (a) the sharded step in a `TorchTrainer`
    gang of one GPU worker per visible card, NCCL; (b) two ranks on one
    card over gloo, at tp=2 and at fsdp=2. `want_losses` is the `train`
    phase's K=1 trajectory, `ref_ms` its graphed step ms at K=1 and K=4."""
    row = parallel_gang(want_losses, ref_ms, model, batch, seq, seed, device)
    row["pairs"], row["pairs_wall_s"] = parallel_pairs(
        row["losses"], model, batch, seq, seed, device)
    return row


def parallel_gang(want_losses, ref_ms, model="gpt2_125m", batch=16,
                  seq=1024, seed=3, device="cuda", workers=None):
    """Phase 16 (a); `workers` (default: one per visible card, one on the
    CPU) sizes the gang."""
    from ray_tpu_torch import train as train_mod
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    card = card_line() if device == "cuda" else "cpu"
    n = workers or (torch.cuda.device_count() if device == "cuda" else 1)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    assert not _port_processes(), _port_processes()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=max(2, n + 1), object_store_memory=256 << 20,
                       **({} if device == "cuda" else {"num_gpus": n}))
    try:
        trainer = train_mod.TorchTrainer(
            _parallel_loop,
            train_loop_config=dict(device=device, model=model, batch=batch,
                                   seq=seq, seed=seed),
            scaling_config=ScalingConfig(num_workers=n, use_gpu=True),
            backend_config=train_mod.TorchConfig(
                distributed="on",
                platform="cuda" if device == "cuda" else "cpu"),
            run_config=RunConfig(name="parallel",
                                 storage_path=str(PARALLEL_DIR)))
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    _assert_clean()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)

    m = result.metrics
    n_layer = getattr(gpt_mod.GPTConfig, model)().n_layer
    steps = PARALLEL_K1_STEPS + 4 * PARALLEL_K4_CALLS
    want_backend = "nccl" if device == "cuda" else "gloo"
    losses = m["losses"]
    worst = max(abs(g - w) / abs(w) for g, w in zip(losses, want_losses))
    # one rank runs `train`'s arithmetic; a split one sums bf16 partial
    # products in another order
    tol = TRAIN_DIST_LOSS_RTOL if n == 1 else PARALLEL_SPLIT_LOSS_RTOL
    k1 = [r["ms"] for r in m["runs"] if r["k"] == 1 and not r["miss"]]
    k4 = [r["ms"] / 4 for r in m["runs"] if r["k"] == 4 and not r["miss"]]
    miss = {r["k"]: r["ms"] / 1e3 for r in m["runs"] if r["miss"]}
    pool = {r["k"]: r["pool_gib"] for r in m["runs"] if r["miss"]}
    row = dict(world=n, mesh=m["mesh"], backend=m["backend"],
               losses=losses, worst_loss_rel=worst, loss_rtol=tol,
               fit_s=fit_s, setup_s=m["setup_s"],
               k1_step_ms=statistics.median(k1), k1_step_ms_all=k1,
               k4_step_ms=statistics.median(k4), k4_step_ms_all=k4,
               ref_ms=ref_ms, miss_s=miss, pool_gib=pool,
               peak_gib=m["peak_gib"], fwd_launches=m["fwd_launches"],
               bwd_launches=m["bwd_launches"],
               fwd_per_step_per_rank=m["fwd_launches"] / steps,
               bwd_per_step_per_rank=m["bwd_launches"] / steps,
               local_shapes=m["local_shapes"],
               cache={r["k"]: r["cache"] for r in m["runs"] if "cache" in r})
    print(f"parallel (a): {n} GPU worker(s), {m['backend']}, mesh "
          f"{m['mesh']}; losses {[round(x, 4) for x in losses]}, worst rel "
          f"difference from `train` K=1 {worst:.2e} (tol {tol}); step ms "
          f"K=1 {row['k1_step_ms']:.2f} (runs {[round(x, 2) for x in k1]}) "
          f"vs `train` K=1 {ref_ms[0]:.2f}; K=4 {row['k4_step_ms']:.2f} vs "
          f"{ref_ms[1]:.2f}; miss {miss} s, graph pool {pool} GiB, peak "
          f"{m['peak_gib']:.2f} GiB; launches per step per rank fwd "
          f"{row['fwd_per_step_per_rank']:.0f} bwd "
          f"{row['bwd_per_step_per_rank']:.0f}; cache {row['cache']}; local "
          f"shapes {m['local_shapes']}; setup {m['setup_s']:.2f} s, fit() "
          f"{fit_s:.2f} s (card: {card})")
    assert (m["backend"], m["world"], m["steps"]) == (want_backend, n,
                                                      steps), m
    assert m["mesh"] == _pick_strategy(n).mesh_axes(n), m["mesh"]
    assert all(np.isfinite(losses)) and worst <= tol, \
        (worst, losses, want_losses[:steps])
    # the flash kernels on this rank's heads: n_layer forwards a step,
    # twice that backward kernels
    per = 1 if device == "cuda" else 0
    assert m["fwd_launches"] == n_layer * steps * per, m["fwd_launches"]
    assert m["bwd_launches"] == \
        n_layer * steps * BWD_KERNELS_PER_CALL * per, m["bwd_launches"]
    for k, calls in ((1, PARALLEL_K1_STEPS), (4, PARALLEL_K4_CALLS)):
        assert row["cache"][k] == {"hits": calls - 1, "misses": 1,
                                   "retraces": 0}, row["cache"]
    return row


def parallel_pairs(losses, model="gpt2_125m", batch=16, seq=1024, seed=3,
                   device="cuda"):
    """Phase 16 (b): two ranks on the one card over gloo, eager, each mesh
    of `PARALLEL_PAIRS` in turn, held to (a)'s `losses`; returns the
    rows and the wall time."""
    card = card_line() if device == "cuda" else "cpu"
    n_layer = getattr(gpt_mod.GPTConfig, model)().n_layer
    per = 1 if device == "cuda" else 0
    pairs = []
    runs, wall_s = _parallel_pair(PARALLEL_PAIRS, model, seed, batch, seq,
                                  device)
    for axes, rows in zip(PARALLEL_PAIRS, runs):
        got = rows[0]["losses"]
        err = max(abs(g - w) / abs(w) for g, w in zip(got, losses))
        heads = getattr(gpt_mod.GPTConfig, model)().n_head // \
            axes.get("tp", 1)
        pair = dict(axes=axes, losses=got, rel_err=err,
                    step_ms=[r["step_ms"] for r in rows],
                    peak_gib=[r["peak_gib"] for r in rows],
                    local_shapes=rows[0]["local_shapes"],
                    fwd_launches=[r["fwd_launches"] for r in rows],
                    bwd_launches=[r["bwd_launches"] for r in rows],
                    heads_per_rank=heads)
        pairs.append(pair)
        print(f"parallel (b) {axes}: two ranks on one card over gloo, "
              f"{heads} heads a rank; losses {[round(x, 4) for x in got]}, "
              f"worst rel difference from (a) {err:.2e} (tol "
              f"{PARALLEL_SPLIT_LOSS_RTOL}); eager step ms by rank "
              f"{[[round(x, 1) for x in r['step_ms']] for r in rows]}; peak "
              f"{[round(x, 2) for x in pair['peak_gib']]} GiB; launches fwd "
              f"{pair['fwd_launches']} bwd {pair['bwd_launches']}; local "
              f"shapes {pair['local_shapes']} (card: {card})")
        assert [r["losses"] for r in rows] == [got, got], rows
        assert err <= PARALLEL_SPLIT_LOSS_RTOL, (axes, got, losses)
        for r in rows:
            assert r["backend"] == "gloo" and r["mesh"] == axes, r
            assert r["fwd_launches"] == n_layer * PARALLEL_PAIR_STEPS * per
            assert r["bwd_launches"] == \
                n_layer * PARALLEL_PAIR_STEPS * BWD_KERNELS_PER_CALL * per
    print(f"parallel (b): both meshes in {wall_s:.1f} s (two processes' "
          f"start, gloo group, setup and steps)")
    return pairs, wall_s


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
                 spec, runtime, serve_row, train_dist, train_data, dag,
                 cluster, operator, parallel, ptxas):
    """The `kernels` entries: every ported kernel with its numbers. The
    forward at the serving path's largest prefill shape (with the GPT-2
    run's launches per prefill bucket at that bucket's time), the
    backward at the GPT-2 training shape, and both at each training
    path's shape (`training_paths`). `launches` are
    the GPT-2 serving run's (forward) and the GPT-2 training run's
    (backward); `launches_*` the other main paths' (`engine_spec`: both
    spec runs, and of them the draft prefills; `runtime`: the GPU
    worker's and the GPU actor's engine, as they counted them; `serve`:
    the GPU replica's, on both paths; `train_dist`: the `TorchTrainer`'s
    GPU worker's, both attempts; `train_data`: the Dataset-fed
    `TorchTrainer` GPU worker's; `dag`: the fused chain's executes;
    `dag_actor`: the actor graph's GPU actor's; `cluster`: the GPU step's
    worker on the autoscaled node; `operator`: the GPU replica that
    `serve-deploy` started; `parallel`: the sharded step's GPU worker
    (rank 0 of the NCCL mesh), and `parallel_pairs` each two-rank gloo
    run's ranks on the one card)."""
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
        "launches_runtime": runtime["launches"],
        "launches_serve": serve_row["launches"],
        "launches_train_dist": train_dist["fwd_launches"],
        "launches_train_data": train_data["fwd_launches"],
        "launches_dag": dag["fused"]["launches"],
        "launches_dag_actor": dag["actor"]["launches"],
        "launches_cluster": cluster["launches"],
        "launches_operator": operator["launches"],
        "launches_parallel": parallel["fwd_launches"],
        "launches_parallel_pairs": {
            str(p["axes"]): p["fwd_launches"] for p in parallel["pairs"]},
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
        "launches_train_dist": train_dist["bwd_launches"],
        "launches_train_data": train_data["bwd_launches"],
        "launches_parallel": parallel["bwd_launches"],
        "launches_parallel_pairs": {
            str(p["axes"]): p["bwd_launches"] for p in parallel["pairs"]},
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
    t_start = time.perf_counter()
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
    # the port's runtime: the GPT-2 engine phase's model from a GPU actor
    runtime = phase_runtime(gpt)
    # Serve: the GPT-2 engine phase's model from a GPU replica
    serve_row = phase_serve(gpt)
    # the cluster phase's reference: the `gpt` phase's tokens and gaps
    gpt_ref = dict(tokens=gpt["tokens"], gaps=gpt["gaps"])
    for row in (gpt, llama):  # the later phases' references, not results
        del row["tokens"], row["gaps"]
    # the distributed train plane: the `train` phase's model, weights and
    # batch in a TorchTrainer's GPU worker, a rank killed and replaced
    k1, k4 = train["graphed"]["k1"], train["graphed"]["k4"]
    train_dist = phase_train_dist(k1["losses"],
                                  (k1["step_ms"], k4["step_ms"]))
    # the `train` cell fed from a streaming Dataset through a TorchTrainer
    train_data = phase_train_data((k1["step_ms"], k4["step_ms"]))
    # the compiled DAG: a fused chain as one graph, an actor graph
    dag = phase_dag()
    # the soak: runtime, Data, train plane, chaos and ledger (on the CPU)
    soak = phase_soak()
    # the cluster tooling: a submitted job's workflow step on a GPU node
    # that the autoscaler launches for it and retires once idle
    cluster = phase_cluster(gpt_ref)
    # the operator surface: the CLI's verbs, a client:// driver, GPT-2
    # deployed by `serve-deploy`, the dashboard
    operator = phase_operator(gpt_ref)
    # parallel/: the `train` cell through a sharded step on a mesh, in a
    # TorchTrainer gang (NCCL), then two ranks on the card over gloo
    parallel = phase_parallel(k1["losses"], (k1["step_ms"], k4["step_ms"]))

    kernels = kernels_line(rows, bwd_rows, train, train_llama, train_long,
                           gpt, llama, spec, runtime, serve_row, train_dist,
                           train_data, dag, cluster, operator, parallel,
                           ptxas)
    print(json.dumps({"build_s": build_s, "train": train,
                      "train_llama": train_llama, "train_long": train_long,
                      "engines": [gpt, llama], "engine_spec": spec,
                      "runtime": runtime, "serve": serve_row,
                      "train_dist": train_dist, "train_data": train_data,
                      "dag": dag, "soak": soak, "cluster": cluster,
                      "operator": operator, "parallel": parallel}))
    print(json.dumps({"kernels": kernels}))
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all, the build "
          f"{build_s:.1f} s of it")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
