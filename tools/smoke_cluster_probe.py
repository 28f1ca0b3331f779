#!/usr/bin/env python3
"""The cluster phases of `chip_smoke.py` alone, on one GPU.

    python3 tools/smoke_cluster_probe.py

Runs the smoke's build, its `gpt` engine phase (the reference tokens),
then phase 14 (`cluster`) and phase 13 (`soak`, local and cluster mode),
with the smoke's checks; about 3.5 minutes on an H100 where the whole
smoke takes about 9. Prints each phase's lines and its row as JSON.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import gpt as gpt_mod  # noqa: E402

t0 = time.perf_counter()
print(cs.card_line(), flush=True)
cs.phase_build()
gpt = cs.phase_engine("gpt", gpt_mod, gpt_mod.GPTConfig.gpt2_125m(),
                      gpt_mod.GPT, buckets=cs.GPT_BUCKETS,
                      prompt_lens=cs.GPT_PROMPT_LENS, max_new=32, seed=1)
ref = dict(tokens=gpt["tokens"], gaps=gpt["gaps"])
row = cs.phase_cluster(ref)
print("CLUSTER_ROW " + json.dumps(row, default=str), flush=True)
soak = cs.phase_soak()
print("SOAK_ROW " + json.dumps(soak, default=str), flush=True)
print(f"probe: {time.perf_counter() - t0:.1f} s", flush=True)
