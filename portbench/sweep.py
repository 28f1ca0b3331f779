"""The knee of an open-loop serving mix, found once on the card.

    python3 -m portbench.sweep --workload NAME --rates 10,20,30 [--seconds S]

One engine serves the mix at each rate in turn, for S seconds of
arrivals each. While it does, the engine's waiting queue is read every
quarter second; one JSON line per rate gives the queue's growth (the
slope of a line fitted to the second half of the readings, requests a
second), its last depth, and the TTFT and TPOT tails of the rate's
requests. The knee is the highest rate whose queue does not grow; the
mix's file holds 0.8 of it as its `rate`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import spec, traffic
from portbench.drivers.serve import DRAIN_S, Load, _p95
from portbench.run import cache_env, process_start_wall


def main(argv=None) -> int:
    t_start = process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    cache_env(root)
    import torch

    cfg = spec.config(bench, root, cell["config"])
    tr = spec.traffic(cell["traffic"])
    fam = spec.family(cfg["family"])
    dev = torch.device("cuda")
    job = SimpleNamespace(t_start=t_start)
    params = fam.make_params(cfg, args.seed, dev, train=False)
    engine = fam.engine(cfg, params, tr["engine"], dev)
    engine.warmup()
    engine.start()
    for rate in (float(r) for r in args.rates.split(",")):
        tr_r = dict(tr, rate=rate)
        dues = traffic.arrivals(tr_r, args.seconds)
        load = Load(engine, tr_r,
                    traffic.requests(tr_r, cfg, args.seed, len(dues)))
        t0 = time.perf_counter() + 0.01
        load.start_open(t0, dues)
        depth = []
        while time.perf_counter() < t0 + args.seconds:
            depth.append((time.perf_counter() - t0,
                          engine.metrics()["queue_depth"]))
            time.sleep(0.25)
        load.finish(t0 + args.seconds + DRAIN_S)
        half = [(t, d) for t, d in depth if t >= args.seconds / 2]
        slope = float(np.polyfit(*zip(*half), 1)[0]) if len(half) > 2 \
            else float("nan")
        done = [r for r in load.sent if r.get("stamps")
                and len(r["tokens"]) == r["spec"]["output"]]
        print(json.dumps({
            "rate": rate, "sent": len(load.sent), "completed": len(done),
            "queue_slope_per_s": slope, "queue_last": depth[-1][1],
            "queue_max": max(d for _, d in depth),
            "ttft_p95_ms": _p95([r["stamps"][0] - r["due"]
                                 for r in done]) * 1e3,
            "tpot_p95_ms": _p95([(r["stamps"][-1] - r["stamps"][0])
                                 / (len(r["stamps"]) - 1) for r in done
                                 if len(r["stamps"]) > 1]) * 1e3,
            "elapsed_s": time.time() - job.t_start}), flush=True)
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
