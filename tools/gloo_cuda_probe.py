#!/usr/bin/env python3
"""Does gloo run the sharded step's collectives on CUDA tensors between
two processes on one card?

    python3 tools/gloo_cuda_probe.py [--world 2] [--device cuda]

Starts WORLD processes that share the first visible device, forms a gloo
group (a file store in a temporary directory) and runs each collective
that `ray_tpu_torch.parallel` issues (`all_gather_into_tensor`,
`reduce_scatter_tensor`, `all_to_all_single`, `all_reduce` with SUM and
MAX, `batch_isend_irecv`) on tensors on that device, checking each value.
Prints one JSON line per rank ({op: "ok" or the error text}) and, last,
{"all_ok": bool}. NCCL refuses two ranks on one device; this decides
whether more than one rank can share the card at all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def _rank(rank: int, world: int, store: str, device: str) -> dict:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    r = float(rank)
    out = {}

    def check(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe reports each op
            out[name] = f"{type(e).__name__}: {e}"[:400]

    def gather():
        got = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(got, torch.full((2,), r, device=dev))
        want = torch.arange(world, device=dev).repeat_interleave(2).float()
        assert torch.equal(got, want), got

    def scatter():
        got = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(got, torch.arange(2.0 * world,
                                                     device=dev) + r)
        base = torch.arange(2.0, device=dev) + 2 * rank
        want = base * world + sum(range(world))
        assert torch.equal(got, want), got

    def a2a():
        got = torch.empty(world, device=dev)
        dist.all_to_all_single(got, torch.arange(float(world), device=dev)
                               + 10 * r)
        want = rank + 10 * torch.arange(float(world), device=dev)
        assert torch.equal(got, want), got

    def reduce(op, want):
        def run():
            x = torch.tensor([r], device=dev)
            dist.all_reduce(x, op=op)
            assert x.item() == want, x
        return run

    def p2p():
        got = torch.empty(1, device=dev)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.tensor([r], device=dev),
                       (rank + 1) % world),
            dist.P2POp(dist.irecv, got, (rank - 1) % world)])
        for q in reqs:
            q.wait()
        assert got.item() == (rank - 1) % world, got

    check("all_gather_into_tensor", gather)
    check("reduce_scatter_tensor", scatter)
    check("all_to_all_single", a2a)
    check("all_reduce_sum", reduce(dist.ReduceOp.SUM,
                                   float(sum(range(world)))))
    check("all_reduce_max", reduce(dist.ReduceOp.MAX, float(world - 1)))
    check("batch_isend_irecv", p2p)
    dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        print(json.dumps({"rank": args.rank, **_rank(
            args.rank, args.world, args.store, args.device)}), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--world", str(args.world), "--rank",
             str(r), "--store", store, "--device", args.device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(args.world)]
        results = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            line = out.strip().splitlines()[-1] if out.strip() else None
            results.append(json.loads(line) if line else
                           {"rc": p.returncode, "stderr": err[-2000:]})
    for res in results:
        print(json.dumps(res))
    ok = all(all(v == "ok" for k, v in res.items() if k != "rank")
             and "stderr" not in res for res in results)
    print(json.dumps({"all_ok": ok}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
