"""Training cells: `TrainStepRunner` at one CUDA graph a step.

Set-up builds one training step (the port's model over f32 master weights
made from the seed, its loss, `torch.optim.AdamW(capturable=True)` as
`chip_smoke.phase_train` wires it) and drives it through its first
`checked_steps` steps with the window's own call and feed, on batches
whose rows all differ: the first call runs the step eagerly and captures
it, the others replay. Those steps give the program's side of the output
check; the window then replays the same object for `--seconds`, one call
a step, each call synchronized by the runner's step recorder.
"""

from __future__ import annotations

import gc
import time

from portbench import checks, peaks, profiler, spec, traffic
from portbench.trail import say
from portbench.reference.precision import PRECISIONS, no_tf32
from portbench.reference import train as ref_train


def adamw_carry(model, opt) -> dict:
    """The step's carry: the parameters and AdamW's state, created as
    AdamW creates it at its first step (capturable: `step` a tensor), so
    that the first call's signature is that of every later call (a copy of
    `chip_smoke._adamw_carry`)."""
    import torch

    params = dict(model.named_parameters())
    for p in params.values():
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=p.device),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return {"params": params,
            **{key: {n: opt.state[p][key] for n, p in params.items()}
               for key in ("exp_avg", "exp_avg_sq", "step")}}


def head_rows(tr: dict, batches: list) -> float:
    """Positions the LM head is needed at, a step (mean over the
    batches)."""
    if tr["objective"] == "causal_lm":
        return float(tr["batch"] * tr["seq"])
    return sum(int((b["y"] != -1).sum()) for b in batches) / len(batches)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(job):
    """Everything up to the window: returns the state the window and the
    check use."""
    import torch

    from ray_tpu_torch.train import TrainStepRunner

    cfg, tr, dev = job.cfg, job.tr, job.device
    opt_cfg = tr["optimizer"]
    params = job.fam.make_params(cfg, job.seed, dev, train=True)
    batches = traffic.train_batches(tr, cfg, job.seed, dev)
    say(job, "weights and batches made")
    # the reference's copy of the initial weights, off the device
    init = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    model = job.fam.train_model(cfg, params)
    opt = torch.optim.AdamW(model.parameters(), lr=opt_cfg["lr"],
                            betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"],
                            weight_decay=opt_cfg["weight_decay"],
                            capturable=dev.type == "cuda")
    carry = adamw_carry(model, opt)
    fam = job.fam

    def train_step(carry, batch):
        loss = fam.loss(model, batch)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return carry, loss.detach()

    runner = TrainStepRunner(train_step, device=dev)
    b1 = opt_cfg["betas"][0]
    losses, grad1 = [], None
    for i in range(tr["checked_steps"]):
        carry, loss = runner.run(carry, batches[i])
        losses.append(float(loss))
        say(job, f"checked step {i + 1}")
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) * g
            grad1 = {u: float(x.norm()) / (1 - b1)
                     for n, t in carry["exp_avg"].items()
                     for u, x in fam.check_parts(n, t).items()}
    change = {u: float(x.norm())
              for n, t in carry["params"].items()
              for u, x in fam.check_parts(
                  n, t.detach() - init[n].to(dev)).items()}
    return {"runner": runner, "carry": carry, "batches": batches,
            "checked": batches[:tr["checked_steps"]],
            "init": init, "model": model, "opt": opt,
            "program": {"losses": losses, "grad1": grad1, "change": change}}


def window(job, st) -> dict:
    """Calls of the runner for `seconds`: every step completed counts."""
    runner, batches = st["runner"], st["batches"]
    carry = st["carry"]
    n = len(batches)
    i = job.tr["checked_steps"]
    call_ms = []
    _sync(job.device)
    t0 = time.perf_counter()
    setup_s = time.time() - job.t_start
    while True:
        c0 = time.perf_counter()
        if c0 - t0 >= job.seconds:
            break
        carry, loss = runner.run(carry, batches[i % n])
        i += 1
        call_ms.append((time.perf_counter() - c0) * 1e3)
    _sync(job.device)
    elapsed = time.perf_counter() - t0
    last_loss = float(loss) if call_ms else float("nan")
    st["carry"], st["next"] = carry, i
    tokens = job.tr["batch"] * job.tr["seq"]
    return {"steps": len(call_ms), "elapsed_s": elapsed, "setup_s": setup_s,
            "call_ms": call_ms, "last_loss": last_loss,
            "tokens_per_s": len(call_ms) * tokens / elapsed}


def trace(job, st) -> profiler.Trace:
    """The device trace of `profile_steps` more steps of the same
    object."""
    runner, batches = st["runner"], st["batches"]
    n = len(batches)

    def body():
        carry, i = st["carry"], st["next"]
        for _ in range(job.tr["profile_steps"]):
            carry, _ = runner.run(carry, batches[i % n])
            i += 1
        _sync(job.device)
        st["carry"], st["next"] = carry, i

    return profiler.record(body)


def free(st):
    """Drops the program's state (its graph included) before the
    reference runs."""
    import torch

    from ray_tpu_torch.parallel.compile_cache import global_cache

    keep = {k: st[k] for k in ("init", "checked", "program")}
    st.clear()
    global_cache().clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return keep


def reference(job, init: dict, batches: list, precision="float32",
              half=False) -> dict:
    """The reference's first steps from the same weights and batches."""
    import torch

    no_tf32()
    ref = spec.reference(job.fam.REFERENCE)
    params0 = {n: t.to(job.device, torch.float32) for n, t in init.items()}
    return ref_train.steps(ref.nll_sum, params0, batches, job.cfg,
                           job.tr["optimizer"], PRECISIONS[precision],
                           rows=job.tr["reference_rows"],
                           split=job.fam.check_parts, half=half)


def run(job) -> dict:
    import torch

    st = setup(job)
    say(job, f"set up; checked losses {st['program']['losses']}")
    hr = head_rows(job.tr, st["batches"])
    win = window(job, st)
    say(job, f"window closed: {win['steps']} steps in {win['elapsed_s']:.3f} s")
    tr_obj = trace(job, st) if job.trace else None
    peak = torch.cuda.max_memory_allocated() \
        if job.device.type == "cuda" else 0
    kept = free(st)
    say(job, "program freed; reference")
    ref = reference(job, kept["init"], kept["checked"])
    say(job, f"reference losses {ref['losses']}")
    readings = checks.train_readings(kept["program"], ref)
    flops = peaks.train_flops(job.fam.shape(job.cfg), job.tr["batch"],
                              job.tr["seq"], job.fam.CAUSAL, hr)
    failed = 0 if win["last_loss"] == win["last_loss"] else 1
    ctx = {"window": win, "trace": tr_obj,
           "flops_per_step": flops, "shape": job.fam.shape(job.cfg),
           "causal": job.fam.CAUSAL, "traffic": job.tr,
           "profile_steps": job.tr["profile_steps"]}
    return {"e2e": {"train_tokens_per_s": win["tokens_per_s"],
                    "setup_s": win["setup_s"]},
            "attempted": win["steps"], "failed": failed,
            "readings": readings, "ctx": ctx, "memory_peak_bytes": peak,
            "trace": tr_obj,
            "notes": {"program": kept["program"]["losses"],
                      "reference": ref["losses"]}}
