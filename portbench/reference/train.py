"""The reference's training steps: the family's loss (`nll_sum`) in
blocks of rows, its gradient by autograd, and AdamW as
`torch.optim.AdamW` defines it (decoupled weight decay, bias-corrected
moments), all in float32 or with the products in fp8 (`precision`)."""

from __future__ import annotations

import torch


def _norms(tensors: dict, split) -> dict:
    return {unit: float(x.norm()) for n, t in tensors.items()
            for unit, x in split(n, t).items()}


def steps(nll_sum, params0: dict, batches: list, cfg: dict, opt: dict,
          mm, rows: int, split, half: bool = False) -> dict:
    """Runs len(batches) AdamW steps from `params0` (float32 tensors on
    the device). Returns each step's loss (the mean NLL over the step's
    counted targets), the gradient norm at step 1 and the change (norm of
    p - p0) after the last step, of each unit `split(name, tensor)` gives
    ({unit: view}). `half` takes the first
    half of each batch's rows only (a fault the checks must catch)."""
    lr, (b1, b2), eps, wd = opt["lr"], opt["betas"], opt["eps"], \
        opt["weight_decay"]
    p = {n: t.detach().clone().requires_grad_() for n, t in params0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad1 = [], None
    for k, batch in enumerate(batches, start=1):
        n_rows = batch["x"].shape[0] // 2 if half else batch["x"].shape[0]
        count = int((batch["y"][:n_rows] != -1).sum())
        total = 0.0
        for lo in range(0, n_rows, rows):
            hi = min(lo + rows, n_rows)
            part = {key: x[lo:hi] for key, x in batch.items()}
            s, _ = nll_sum(p, part, cfg, mm)
            (s / count).backward()
            total += float(s.detach())
        losses.append(total / count)
        with torch.no_grad():
            if k == 1:
                grad1 = _norms({n: t.grad for n, t in p.items()}, split)
            c1, c2 = 1 - b1 ** k, 1 - b2 ** k
            for n, t in p.items():
                g = t.grad
                t.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / c2 ** 0.5).add_(eps)
                t.addcdiv_(m[n], denom, value=-lr / c1)
                t.grad = None
    with torch.no_grad():
        change = _norms({n: t - params0[n] for n, t in p.items()}, split)
    return {"losses": losses, "grad1": grad1, "change": change}
