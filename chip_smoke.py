#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (`nvcc`) and this checkout; no
network, no JAX. Phases, each of which raises (and so ends the run with
a non-zero exit) on any failed check:

1. device: the card's name and power limit (nvidia-smi) and versions;
2. build: every CUDA kernel source of the port, compiled from the
   checkout (`ray_tpu_torch/ops/csrc/*.cu`), with ptxas' register and
   shared-memory report;
3. kernels: `flash_attention_fwd` against its plain PyTorch version on
   the card at the serving shapes (GPT-2 prefill, Llama GQA, non-causal,
   the long-T regime, f32/fp16, head_dim 16/32/128), with the kernel's time,
   the plain version's, a PyTorch library call's (a yardstick only) and
   the least time the card could take;
4. serving: GPT-2 125M through `LLMEngine` at full width (random
   weights from a seed, bf16): requests of 5-900 prompt tokens, two of
   them sharing a 64-token prefix, 32 new tokens each. Checks: every
   request finishes with the right length, the flash kernel ran
   n_layer times per prefill, no KV page leaked, and each request's
   first-token logits agree with a plain-attention prefill on the card.
   Then the same, shorter, for Llama-125M (grouped-query attention);
5. the `kernels` JSON line (every ported kernel with its numbers), the
   card line, and last the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_plain)
from ray_tpu_torch.parallel.ring_attention import full_attention
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

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
# First-token logits, flash prefill vs plain prefill, bf16 through every
# layer of the model: logits are ~N(0, 0.55) at init, and bf16 rounding
# differences in attention propagate through 12 residual blocks.
LOGIT_ATOL = 0.1


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


def attention_bound(b, t, h, h_kv, d, dtype, causal):
    """Least time (ms) the card could take: the larger of the bytes the
    function must move (q, k, v read once; O and lse written once) over
    HBM bandwidth and its FLOPs (QK^T and PV over the (q, k) pairs this
    mask keeps) over the peak rate of the units the kernel uses."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * t * h * d + 2 * b * t * h_kv * d) * elt + b * h * t * 4
    pairs = t * (t + 1) / 2 if causal else t * t
    flops = 4.0 * b * h * d * pairs
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def library_attention(q, k, v, causal):
    """One PyTorch call computing the same function (yardstick only)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if k.shape[2] != q.shape[2]:
        g = q.shape[2] // k.shape[2]
        kt = kt.repeat_interleave(g, dim=1)
        vt = vt.repeat_interleave(g, dim=1)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def profile_steps(fn, steps: int):
    """Device time of `steps` calls of `fn` from a torch.profiler trace:
    per-step wall time, device busy time (the sum of kernel durations)
    and the busy share, plus the kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time_total)
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return dict(
        wall_ms=wall_us / 1e3 / steps,
        device_ms=busy_us / 1e3 / steps if busy_us else None,
        busy_share=busy_us / wall_us if busy_us else None,
        kernels_per_step=sum(n for n, _ in by_name.values()) / steps,
        flash_ms=sum(us for name, (_, us) in by_name.items()
                     if "flash_fwd_kernel" in name) / 1e3 / steps,
        top=[(name[:70], us / 1e3 / steps) for name, (_, us) in top])


# -- phases -----------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    seconds = _build.build()
    wall = time.perf_counter() - t0
    print(f"build: {len(seconds)} source(s) compiled in {wall:.1f} s "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    for name in _build.sources():
        log = _build.log_path(name)
        if log.is_file():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas[{name}]: {line.strip()}")
    return wall


GPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
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
]
MAIN_SHAPE = "gpt2 prefill T=1024"


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
            iters = 5 if t >= 2048 else 20
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
                       causal=causal, max_abs_err=err, lse_err=lse_err,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print(f"kernel {label:24s} O err {err:.2e} lse err "
                  f"{lse_err:.2e} | kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms | bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}) = "
                  f"{bound_ms / ms:.1%} of roofline")
    return rows


class _SmokeEngine(LLMEngine):
    """The engine, keeping each request's first-token logits for the
    plain-attention check."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.first_logits = {}

    def _emit_first(self, seq, next_logits_row):
        self.first_logits[seq.req.id] = next_logits_row.float().cpu()
        return super()._emit_first(seq, next_logits_row)


def phase_engine(name, mod, cfg, net_cls, buckets, prompt_lens, max_new,
                 seed, device="cuda"):
    print(f"engine[{name}]: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = mod.init_params(cfg, gen, device=device)
    eng = _SmokeEngine(
        model=name, model_cfg=cfg, params=params, device=device,
        engine_config=EngineConfig(batch_buckets=(1, 2, 4, 8),
                                   prefill_buckets=buckets))
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    shared = list(rng.integers(1, cfg.vocab_size, 64))
    prompts = []
    for i, n in enumerate(prompt_lens):
        if i in (2, 3):  # two requests share a 64-token prefix
            prompts.append(shared + list(rng.integers(1, cfg.vocab_size,
                                                      n - 64)))
        else:
            prompts.append(list(rng.integers(1, cfg.vocab_size, n)))
    prompts = [[int(x) for x in p] for p in prompts]

    # the main path: counts at 0 just before, read just after
    flash_attention.launches = 0
    eng.start()  # served by the pump thread, as a replica would
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    outs = [r.result(timeout=600) for r in reqs]
    gen_s = time.perf_counter() - t0
    eng.quiesce()
    eng.stop()
    launches = flash_attention.launches
    m = eng.metrics()
    prefill_calls = {int(key.split(":")[1]): c
                     for key, c in m["bucket_calls"].items()
                     if key.startswith("prefill:")}
    prefills = sum(prefill_calls.values())

    for r, out in zip(reqs, outs):
        assert r.finish_reason == "length" and len(out) == max_new, (
            r.id, r.finish_reason, len(out))
        assert all(0 <= t < cfg.vocab_size for t in out)
    assert launches == cfg.n_layer * prefills > 0, (launches, prefills)
    assert m["prefix_cache_hits"] >= 1, m  # the shared-prefix chunk path

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

    # step times of the engine's own step functions, after the run
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

        top_bucket = max(buckets)
        decode_ms = host_ms(decode_b8)
        profiles = {
            "decode_b8": profile_steps(decode_b8, 10),
            f"prefill_{top_bucket}": profile_steps(
                lambda: eng._prefill([[1] * top_bucket], [top_bucket]), 3)}
    leaked = eng.shutdown()
    assert leaked == 0, f"{leaked} KV pages leaked"
    n_tok = sum(len(o) for o in outs)
    row = dict(model=name, n_layer=cfg.n_layer, warmup_s=warmup_s,
               requests=len(reqs),
               prompt_lens=prompt_lens, new_tokens=n_tok,
               gen_s=gen_s, tokens_per_s=n_tok / gen_s,
               flash_launches=launches, prefills=prefills,
               prefill_calls=prefill_calls,
               chunk_steps=m["chunk_steps"], decode_steps=m["decode_steps"],
               prefix_cache_hit_tokens=m["prefix_cache_hit_tokens"],
               first_logit_max_diff=worst, leaked_pages=leaked,
               prefill_ms=prefill_ms, decode_ms_b8=decode_ms,
               profiles=profiles,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"engine[{name}]: warm-up {warmup_s:.2f} s, {len(reqs)} requests "
          f"x {max_new} tokens in {gen_s:.3f} s = {n_tok / gen_s:.1f} "
          f"tok/s; flash launches {launches} = {cfg.n_layer} x "
          f"{prefills} prefills; chunk steps {m['chunk_steps']}; "
          f"first-token logits max diff vs plain {worst:.4f}; leaked "
          f"{leaked}")
    print(f"engine[{name}]: prefill ms by bucket "
          f"{ {s: round(v, 3) for s, v in prefill_ms.items()} }; decode "
          f"{decode_ms:.3f} ms/step at batch 8")
    for key, p in profiles.items():
        busy = "not measured" if p["busy_share"] is None else \
            f"{p['device_ms']:.3f} ms device busy = {p['busy_share']:.1%}"
        print(f"engine[{name}]: profile {key}: {p['wall_ms']:.3f} ms/step "
              f"wall, {busy}, {p['kernels_per_step']:.0f} kernels/step, "
              f"flash {p['flash_ms']:.3f} ms; top {p['top']}")
    return row


def kernels_line(rows, gpt, llama):
    """The `kernels` entries: every ported kernel with its numbers, at
    the main path's largest prefill shape, plus the GPT-2 run's launches
    per prefill bucket at that bucket's kernel time."""
    main_row = next(r for r in rows if r["shape"] == MAIN_SHAPE)
    # the GPT-2 run's launches per prefill bucket, at that bucket's time
    by_t = {r["t"]: r for r in rows if r["shape"].startswith("gpt2")}
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
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": MAIN_SHAPE,
        "main_path": main_path,
        "main_path_kernel_ms": sum(r["launches"] * r["ms"]
                                   for r in main_path),
        "shapes": rows,
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
    build_s = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)

    gpt = phase_engine(
        "gpt", gpt_mod, gpt_mod.GPTConfig.gpt2_125m(), gpt_mod.GPT,
        buckets=GPT_BUCKETS,
        prompt_lens=[5, 17, 67, 104, 200, 333, 600, 900], max_new=32,
        seed=1)
    llama = phase_engine(
        "llama", llama_mod, llama_mod.LlamaConfig.llama_125m(),
        llama_mod.Llama,
        buckets=LLAMA_BUCKETS,
        prompt_lens=[9, 150, 69, 94, 1500], max_new=16, seed=2)

    kernels = kernels_line(rows, gpt, llama)
    print(json.dumps({"build_s": build_s, "engines": [gpt, llama]}))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
