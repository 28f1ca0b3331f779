"""The port's counterpart of `__graft_entry__.py`: a forward step of the
flagship model, and a dry run of every parallelism axis the port ships.

- `entry(device="cuda")`: `(fn, args)`, `fn(*args)` GPT-2 125M's logits on
  128 tokens through the single-card hot path (the flash kernel as the
  attention; its plain version on the CPU).
- `dryrun_multichip(n, device="cuda", weights=None)`: `n` ranks, one
  process each (`parallel.distributed.run_local`: one card and one NCCL
  rank each; with ``device="cpu"`` gloo CPU ranks, where the JAX
  function provisions virtual CPU devices), run the JAX dry run's five
  steps at its shapes and strategies, each held to a one-rank value:

  1. `gpt`: one AdamW step of the tiny GPT (f32) at `pick_strategy(n)`
     (fsdp, tp and sp peeled off by twos, the rest dp), B = 2 dp fsdp,
     T = 16 max(sp, 1); its pre-update loss within rtol 2e-4 of one
     rank's forward with dense attention (`full_attention`, as the JAX
     dry run's reference is). Each rank's heads run the model's
     attention, the flash kernel (head_dim 32) on the card, through
     Ulysses where sp divides them and on the whole sequence gathered
     over sp where it does not (fsdp=2 tp=2 sp=2 leaves each tp rank one
     head);
  2. `ckpt`: the updated parameters saved as a sharded array checkpoint
     and restored, replicated, onto tp=2 x dp=n/2: bit for bit;
  3. `ep`: MoE-GPT tiny at ep = 4 or 2 and dp = n / ep, tokens (2 dp,
     17): its loss (token NLL and router losses) finite and within rtol
     2e-4 of one rank's;
  4. `pp` (pp = 4 or 2, none at pp = 1): a pipeline of tanh(h @ W)
     stages (W 8x8, x and y (4 pp, 8), 2 pp microbatches): the loss
     within rtol 1e-5 and each stage's gradient within atol 1e-5, rtol
     1e-4 of one rank's autograd;
  5. `multislice` (n even, n >= 4): the tiny GPT on a hybrid mesh, dcn=2
     outermost x fsdp=n/2; its loss within rtol 2e-4 of one rank's
     dense forward.

  Tokens are all ones and the pipeline's inputs come from
  `np.random.RandomState(0)`, as in the JAX dry run. `weights` may carry
  the GPT's and MoE-GPT's Flax parameters (`{"gpt": tree, "moe": tree}`,
  numpy, through `models.convert`); by default the port's own init from
  seed 0. Returns rank 0's numbers by step.

    python -m ray_tpu_torch.dryrun 4                 # four cards
    python -m ray_tpu_torch.dryrun 8 --device cpu    # eight gloo ranks
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from functools import partial

import numpy as np

LR = 1e-3               # optax.adamw(1e-3)'s defaults otherwise
LOSS_RTOL = 2e-4        # a sharded loss against one rank's
PP_LOSS_RTOL = 1e-5
PP_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def entry(device="cuda"):
    """(fn, args): `fn(params, tokens)` is GPT-2 125M's forward (bf16,
    random weights from seed 0) on `tokens` [1, 128], the flash kernel as
    its attention."""
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention

    device = resolve_device(device)
    cfg = gpt.GPTConfig.gpt2_125m(remat=False)
    params = gpt.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    tokens = torch.ones((1, 128), dtype=torch.long, device=device)
    attend = partial(flash_attention, causal=True)

    def forward(params, tokens):
        with torch.no_grad():
            return gpt.GPT.from_params(cfg, params, attention_fn=attend)(
                tokens)

    return forward, (params, tokens)


def pick_strategy(n_devices: int):
    """`__graft_entry__._pick_strategy`: factors of two peeled onto fsdp,
    tp and sp in turn; the rest is dp (8: fsdp=2 tp=2 sp=2; 4: fsdp=2
    tp=2)."""
    from ray_tpu_torch.parallel import ShardingStrategy

    axes = {"fsdp": 1, "tp": 1, "sp": 1}
    rem = n_devices
    for name in ("fsdp", "tp", "sp"):
        if rem % 2 == 0:
            axes[name] = 2
            rem //= 2
    return ShardingStrategy(dp=rem, **axes)


def dryrun_multichip(n_devices: int, device="cuda", weights=None,
                     timeout: float = 900.0) -> dict:
    """The five steps (module docstring) on `n_devices` ranks: one card
    and one NCCL rank each on ``"cuda"`` (raises with fewer visible cards:
    no fallback to the CPU), gloo CPU ranks on ``"cpu"``."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.parallel.distributed import run_local

    device = resolve_device(device).type
    if weights is not None:
        # plain dicts of numpy arrays: a Flax FrozenDict would make every
        # rank import flax (and jax) to unpickle it
        weights = {name: _plain(tree) for name, tree in weights.items()}
    return run_local(_dryrun_rank, n_devices, device=device,
                     args=(n_devices, device, weights), timeout=timeout)[0]


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _dryrun_rank(n, device, weights):
    weights = weights or {}
    out = {"world": n, "device": device, "seconds": {}}
    t0 = time.perf_counter()

    def lap(step):
        nonlocal t0
        t1 = time.perf_counter()
        out["seconds"][step] = t1 - t0
        t0 = t1

    out["gpt"], placed = _gpt_step(n, device, weights.get("gpt"))
    lap("gpt")
    out["ckpt"] = _ckpt_step(placed, n, device)
    lap("ckpt")
    out["ep"] = _ep_step(n, device, weights.get("moe"))
    lap("ep")
    out["pp"] = _pp_step(n, device)
    lap("pp")
    out["multislice"] = _multislice_step(n, device, weights.get("gpt"))
    lap("multislice")
    return out


# -- helpers -------------------------------------------------------------------

def _check(ok: bool, what):
    # the dry run's checks hold under `python -O` too
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _close(name, got, want, rtol, atol=0.0):
    _check(np.all(np.isfinite(got)), f"{name}: {got} is not finite")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"dryrun {name}")


def _full_params(family, cfg, tree):
    """The model's parameters (f32 on the CPU): the Flax `tree` carried
    across, else the port's init from seed 0."""
    import torch

    from ray_tpu_torch.models import convert, gpt, moe_gpt

    if tree is not None:
        fn = {gpt: convert.gpt_params_from_jax,
              moe_gpt: convert.moe_gpt_params_from_jax}[family]
        return fn(tree, cfg, device="cpu", dtype=torch.float32)
    return family.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              torch.float32)


def _sharded(family, net_cls, cfg, full, strategy, mesh, **kw):
    """(trainable model over this rank's shards, the placed parameters,
    their placements)."""
    from ray_tpu_torch.parallel import logical_axis_rules
    from ray_tpu_torch.parallel.sharding import param_shardings, shard_params

    shardings = param_shardings(mesh, family.param_logical_axes(cfg),
                                logical_axis_rules(strategy))
    placed = shard_params(full, mesh, shardings)
    return net_cls.from_params(cfg, placed, trainable=True, **kw), placed, \
        shardings


def _train_step(loss_fn, model, mesh, shardings):
    """One AdamW step of `loss_fn()` (this rank's share): the global loss
    before the update."""
    import torch

    from ray_tpu_torch.models import gpt

    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    loss = loss_fn()
    loss.backward()
    gpt.reduce_gradients(params, mesh, shardings)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return float(gpt.global_loss(loss, mesh))


def _local_batch(tokens, mesh, strategy, device):
    """(inputs, targets) of `tokens` [B, T + 1]: this rank's blocks, and
    the whole batch on `device` for the one-rank reference."""
    import torch

    from ray_tpu_torch.parallel import shard_batch

    x, y = np.ascontiguousarray(tokens[:, :-1]), \
        np.ascontiguousarray(tokens[:, 1:])
    data = shard_batch({"x": x, "y": y}, mesh, strategy)
    local = tuple(data[k].to_local().long() for k in ("x", "y"))
    whole = tuple(torch.from_numpy(a).long().to(device) for a in (x, y))
    return local, whole


def _gpt_loss_step(device, tree, strategy, batch, seq):
    """The tiny GPT's step at `strategy` on all-ones tokens [batch, seq +
    1]: (row, placed parameters), held to one rank's loss with dense
    attention, so that the flash kernel on the card is held to it too."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import flash_attention, flash_attention_bwd

    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, remat=False)
    mesh = strategy.build_mesh(device=device)
    attend = partial(flash_attention, causal=True)
    full = _full_params(gpt, cfg, tree)
    (x, y), (xw, yw) = _local_batch(np.ones((batch, seq + 1), np.int64),
                                    mesh, strategy, device)
    with torch.no_grad():
        one = gpt.GPT.from_params(cfg, {k: v.to(device)
                                        for k, v in full.items()})
        ref = float(gpt.cross_entropy_loss(one(xw), yw))
    model, placed, shardings = _sharded(gpt, gpt.GPT, cfg, full, strategy,
                                        mesh, attention_fn=attend)
    # this step's launches: the counters at 0 just before, read after
    flash_attention.launches = flash_attention_bwd.launches = 0
    loss = _train_step(
        lambda: gpt.sharded_loss(model, x, y, mesh, shardings), model, mesh,
        shardings)
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    _close("gpt", loss, ref, LOSS_RTOL)
    heads, sp = cfg.n_head // strategy.tp, strategy.sp
    path = "local" if sp == 1 else "gather" if heads % sp else "ulysses"
    return dict(loss=loss, ref_loss=ref, mesh=mesh.shape,
                batch_local=tuple(x.shape), heads_per_rank=heads,
                sp_path=path, fwd_launches=fwd, bwd_launches=bwd), placed


def _gpt_step(n, device, tree):
    strategy = pick_strategy(n)
    return _gpt_loss_step(device, tree, strategy,
                          2 * strategy.dp * strategy.fsdp,
                          16 * max(strategy.sp, 1))


def _ckpt_step(placed, n, device):
    """`placed` (the updated DTensors) saved, then restored replicated onto
    tp=2 x dp=n/2 (tp=1 for odd n): every leaf bit for bit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.parallel import ShardingStrategy
    from ray_tpu_torch.train import array_checkpoint as ac

    rank = dist.get_rank()
    where = [tempfile.mkdtemp(prefix="dryrun_ckpt_") if rank == 0 else None]
    dist.broadcast_object_list(where)
    base = where[0]
    d = base if rank == 0 else os.path.join(f"{base}_shards",
                                            f"rank_{rank}")
    try:
        ac.save_sharded(d, placed)
        dist.barrier()
        _check(ac.is_usable(base), f"checkpoint {base} unusable")
        tp = 2 if n % 2 == 0 else 1
        alt = ShardingStrategy(tp=tp, dp=n // tp).build_mesh(device=device)
        rep = [Replicate()] * alt.device_mesh.ndim
        like = {name: DTensor.from_local(
            torch.empty(p.shape, dtype=p.dtype, device=device),
            alt.device_mesh, rep, run_check=False)
            for name, p in placed.items()}
        restored = ac.restore_sharded(base, like)
        for name, p in placed.items():
            got = restored[name]
            _check(got.placements == tuple(rep),
                   f"{name} restored as {got.placements}")
            _check(torch.equal(got.to_local(), p.full_tensor()),
                   f"{name} restored with other bits")
        dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(base, ignore_errors=True)
            shutil.rmtree(f"{base}_shards", ignore_errors=True)
    return dict(leaves=len(placed), mesh=alt.shape, bitwise=True)


def _ep_step(n, device, tree):
    """MoE-GPT tiny with its experts over ep: the step's loss against one
    rank's forward of the same weights."""
    import torch

    from ray_tpu_torch.models import gpt, moe_gpt
    from ray_tpu_torch.parallel import ShardingStrategy

    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    strategy = ShardingStrategy(dp=n // ep, ep=ep)
    mesh = strategy.build_mesh(device=device)
    cfg = moe_gpt.MoEGPTConfig.tiny(dtype=torch.float32, remat=False)
    full = _full_params(moe_gpt, cfg, tree)
    (x, y), (xw, yw) = _local_batch(np.ones((2 * strategy.dp, 17),
                                            np.int64), mesh, strategy,
                                    device)
    with torch.no_grad():
        one = moe_gpt.MoEGPT.from_params(cfg, {k: v.to(device)
                                               for k, v in full.items()})
        logits, aux = one(xw)
        ref = float(gpt.cross_entropy_loss(logits, yw)
                    + moe_gpt.total_aux_loss(aux))
    model, _, shardings = _sharded(moe_gpt, moe_gpt.MoEGPT, cfg, full,
                                   strategy, mesh)
    loss = _train_step(
        lambda: moe_gpt.sharded_loss(model, x, y, mesh, shardings), model,
        mesh, shardings)
    _close("ep", loss, ref, LOSS_RTOL)
    return dict(loss=loss, ref_loss=ref, mesh=mesh.shape,
                local_experts=tuple(dict(model.named_parameters())
                                    ["h0.moe.experts_up"].shape))


def _tanh_stage(p, h):
    return (h @ p["w"]).tanh()


def _mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def pipeline_inputs(pp: int):
    """The JAX dry run's stack: pp weights 8x8 (x 0.1), then x and y
    (4 pp, 8), from `np.random.RandomState(0)`, in f32."""
    rng = np.random.RandomState(0)
    ws = np.stack([(rng.randn(8, 8) * 0.1).astype(np.float32)
                   for _ in range(pp)])
    return ws, rng.randn(4 * pp, 8).astype(np.float32), \
        rng.randn(4 * pp, 8).astype(np.float32)


def _pp_step(n, device):
    """The fused-loss pipeline over the first pp ranks (the others wait),
    against one rank's forward and backward of the same stack."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_train_step

    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if pp == 1:
        return None  # a one-stage "pipeline" exercises nothing
    mesh = build_mesh({"pp": pp}, devices=list(range(pp)), device=device)
    row = None
    if dist.get_rank() < pp:
        ws, x, y = (torch.from_numpy(a).to(device)
                    for a in pipeline_inputs(pp))
        loss, grads = pipeline_train_step(
            _tanh_stage, _mse, {"w": ws}, x, y, mesh,
            num_microbatches=2 * pp)
        got_g = grads["w"].full_tensor()
        w = ws.clone().requires_grad_(True)
        h = x
        for i in range(pp):
            h = _tanh_stage({"w": w[i]}, h)
        ref = _mse(h, y)
        ref.backward()
        ref = float(ref.detach())
        _close("pp loss", float(loss), ref, PP_LOSS_RTOL)
        _close("pp grads", got_g.cpu().numpy(), w.grad.cpu().numpy(),
               **PP_GRAD_TOL)
        row = dict(loss=float(loss), ref_loss=ref, stages=pp,
                   microbatches=2 * pp, grads=got_g.cpu().numpy(),
                   max_grad_err=float((got_g - w.grad).abs().max()))
    dist.barrier()
    return row


def _multislice_step(n, device, tree):
    """The tiny GPT at dcn=2 x fsdp=n/2 on a hybrid mesh, dcn outermost."""
    from ray_tpu_torch.parallel import ShardingStrategy

    if n % 2 or n < 4:
        return None  # needs >= 2 slices x >= 2 ranks
    strategy = ShardingStrategy(dcn_dp=2, fsdp=n // 2)
    row, _ = _gpt_loss_step(device, tree, strategy, 2 * 2 * (n // 2), 16)
    _check(list(row["mesh"]) == ["dcn", "fsdp"] and row["mesh"]["dcn"] == 2,
           f"multislice mesh {row['mesh']}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.dryrun",
        description="GPT-2 125M's forward, then the multichip dry run")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (one card each on cuda)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), out.dtype, flush=True)
    rows = dryrun_multichip(args.n, args.device)
    print(json.dumps(rows, default=lambda a: np.asarray(a).tolist()))
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
