"""The benchmark of `ray_tpu_torch`: one run of one cell.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds `BENCHMARK.json`, this package and
`ray_tpu_torch`. The cell's configuration, traffic mix, limits and
per-layer readers are found by name (`spec`). The run makes its weights
and inputs from the seed, warms up every shape its traffic uses (that is
set-up), measures for S seconds, then checks what the timed path produced
against the plain reference (`checks`). The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and last `checks`
(each compared number with its limit), which also end standard error.

It exits non-zero, printing no result, when there is no CUDA device or
fewer than the cell needs, when the program cannot be imported, and when
`jax`, `jaxlib`, `flax` or `ray_tpu` (compared by whole top-level module
name) was loaded.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
STACKS_AFTER_S = 330


def process_start_wall() -> float:
    """When this process started (wall clock), from /proc; the time of
    this call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc builds go to `ray_tpu_torch/ops/build/`, its own fixed
    directory); the request recorder keeps every record of a run."""
    cache = root / "portbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["RAY_TPU_REQ_RING"] = "1000000"


def forbidden_modules() -> list:
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def run_cell(bench: dict, root: Path, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, cfg=None, tr=None) -> dict:
    """One run of cell `name` on `device` (the benchmark's entry; tests
    call it on the CPU with a small `cfg`, and `tr` to shorten the mix).
    Returns the result object."""
    import torch

    from portbench import checks, spec

    cell = spec.cell(bench, name)
    cfg = cfg or spec.config(bench, root, cell["config"])
    tr = tr or spec.traffic(cell["traffic"])
    fam = spec.family(cfg["family"])
    job = SimpleNamespace(cfg=cfg, tr=tr, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device(device),
                          fam=fam, t_start=t_start)
    out = spec.driver(tr["driver"]).run(job)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, name, kind):
        value = out["e2e"].get(m["name"]) if not trace \
            else spec.reader(m["name"])(out["ctx"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    judged = checks.judge(out["readings"], spec.limits(name))
    dev = {"platform": "gpu" if job.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(job.device)
                    if job.device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["failed"] == 0
              and all(ok for _, _, ok in judged.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        dev["busy_s"] = out["trace"].busy_s
        dev["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["notes"] = out.get("notes", {})
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim, _) in judged.items()}
    return result


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    t_start = process_start_wall()
    # where a run still going near its time limit is stuck: every thread's
    # stack on standard error
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False,
                                     file=sys.__stderr__)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from portbench import spec

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    cache_env(root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    result = run_cell(bench, root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    result["device"]["card"] = card_line()
    faulthandler.cancel_dump_traceback_later()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
