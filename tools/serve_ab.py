#!/usr/bin/env python3
"""Two checkouts' Serve on one card, in alternating pairs.

    python tools/serve_ab.py PARENT_DIR CHANGE_DIR [--pairs N] [--log FILE]

Each run is a process of its own started in one checkout: its
`chip_smoke.py` `gpt` phase (the in-process GPT-2 125M engine, seed 1)
and then its `serve` phase (the replica on the Python router path and
on the native ring, then the mid-stream kill). Pair i runs the parent
first when i is even and the change first when it is odd. One line per
run: the checkout, its exit code, the phase's numbers (replica up, tok/s
beside the in-process tok/s, TTFT and TPOT p50/p90 per path; after the
kill the card's memory back and the replacement's first token) and the
`/dev/shm/ray_tpu_torch_*` entries the run left after its process
exited, which are then removed so that the next run's leak check starts
clean. A summary line gives each side's medians. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys

RUN = r'''
import json, chip_smoke as cs
from ray_tpu_torch.models import gpt as gpt_mod
gpt = cs.phase_engine("gpt", gpt_mod, gpt_mod.GPTConfig.gpt2_125m(),
                      gpt_mod.GPT, buckets=cs.GPT_BUCKETS,
                      prompt_lens=cs.GPT_PROMPT_LENS, max_new=32, seed=1)
row = cs.phase_serve(gpt)
keys = ("up_s", "run_s", "tokens_per_s", "in_process_tokens_per_s",
        "ttft_ms_p50_p90", "tpot_ms_p50_p90")
out = {p: {k: r[k] for k in keys} for p, r in row["paths"].items()}
kill = row["paths"]["ring"]["kill"]
out["kill"] = {k: kill[k] for k in ("free_after_kill_s",
                                    "replacement_first_token_s")}
print("SERVE_AB " + json.dumps(out), flush=True)
'''

# (name, getter) of the numbers the summary takes medians of
SUMMARY = (
    ("python_tok_s", lambda r: r["python"]["tokens_per_s"]),
    ("ring_tok_s", lambda r: r["ring"]["tokens_per_s"]),
    ("in_process_tok_s", lambda r: r["ring"]["in_process_tokens_per_s"]),
    ("python_ttft_p50_ms", lambda r: r["python"]["ttft_ms_p50_p90"][0]),
    ("ring_ttft_p50_ms", lambda r: r["ring"]["ttft_ms_p50_p90"][0]),
    ("python_tpot_p50_ms", lambda r: r["python"]["tpot_ms_p50_p90"][0]),
    ("ring_tpot_p50_ms", lambda r: r["ring"]["tpot_ms_p50_p90"][0]),
    ("replacement_first_token_s",
     lambda r: r["kill"]["replacement_first_token_s"]),
)


def _leftovers():
    return sorted(glob.glob("/dev/shm/ray_tpu_torch_*"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--log", default=None,
                    help="file for each run's whole output")
    args = ap.parse_args()
    log = open(args.log, "w") if args.log else None
    rows = {"parent": [], "change": []}
    failed = 0
    for i in range(args.pairs):
        sides = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in sides:
            p = subprocess.run([sys.executable, "-c", RUN],
                               cwd=getattr(args, side), capture_output=True,
                               text=True, timeout=900)
            if log is not None:
                log.write(f"==== pair {i} {side} rc={p.returncode}\n"
                          f"{p.stdout[-20000:]}\n{p.stderr[-4000:]}\n")
                log.flush()
            left = _leftovers()
            for path in left:
                os.unlink(path)
            got = [ln for ln in p.stdout.splitlines()
                   if ln.startswith("SERVE_AB ")]
            row = json.loads(got[-1][len("SERVE_AB "):]) if got else None
            failed += p.returncode != 0 or row is None
            if row is not None:
                rows[side].append(row)
            print(json.dumps({"pair": i, "side": side, "rc": p.returncode,
                              "row": row, "left": left}), flush=True)
    print(json.dumps({"medians": {
        side: {name: statistics.median(get(r) for r in rs)
               for name, get in SUMMARY} if rs else None
        for side, rs in rows.items()}, "runs": {
            side: len(rs) for side, rs in rows.items()}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
