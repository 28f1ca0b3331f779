"""The readings that each output check's limit is set from, on the card.

    python3 -m portbench.calibrate --workload NAME --seeds 1,2,3 [--seconds S]

For each seed, in one process, one JSON line on standard output:

- training cells: the checked numbers (`checks.train_readings`) of the
  program's first steps against the float32 reference (`program`), of the
  reference computed with fp8 products against it (`control`: the step
  below the configurations' bfloat16), and of the reference that leaves
  out half of each batch and takes the mean over the rest (`half_batch`,
  a fault the checks must catch; a state left unchanged reads 1 on
  `change_gap` and needs no run);
- serving cells: a run of the cell (`--seconds` of the cell's own load)
  and its `logit_gap` (`program`), and the gap of the tokens that the
  fp8 reference puts first at the same positions of the same sampled
  requests (`control`).

`PERF.md` gives the readings and the limits set from them
(`limits/<cell>.json`).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from portbench import checks, spec
from portbench.run import cache_env, process_start_wall


def _train(job) -> dict:
    from portbench.drivers import train as dt

    st = dt.setup(job)
    kept = dt.free(st)
    batches = kept["checked"]
    ref = dt.reference(job, kept["init"], batches)
    out = {"program": checks.train_readings(kept["program"], ref),
           "program_worst": checks.worst_units(kept["program"], ref)}
    for name, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"half": True})):
        other = dt.reference(job, kept["init"], batches, **kw)
        out[name] = checks.train_readings(other, ref)
    return out


def _serve(job) -> dict:
    from portbench.drivers import serve as ds

    res = ds.run(job)
    out = {"program": res["readings"], "failed": res["failed"],
           "attempted": res["attempted"],
           "control": {"logit_gap": ds.logit_gap(
               job, res["params"], res["sampled"], control="fp8")}}
    del res
    gc.collect()
    return out


def main(argv=None) -> int:
    t_start = process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    cache_env(root)
    import torch

    cfg = spec.config(bench, root, cell["config"])
    tr = spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        job = SimpleNamespace(cfg=cfg, tr=tr, seed=seed,
                              seconds=args.seconds, trace=False,
                              device=torch.device("cuda"),
                              fam=spec.family(cfg["family"]),
                              t_start=t_start)
        t0 = time.time()
        out = (_train if tr["driver"] == "train" else _serve)(job)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.time() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
