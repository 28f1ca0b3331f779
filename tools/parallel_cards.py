#!/usr/bin/env python3
"""`chip_smoke.py` phase 16 (a) alone, on every visible card; or the
multichip dry run, or ViT-B/16 over tp and sp, on four.

    python3 tools/parallel_cards.py            # on a host with four cards
    python3 tools/parallel_cards.py llama      # Llama-125M instead
    python3 tools/parallel_cards.py dryrun     # dryrun_multichip(4)
    python3 tools/parallel_cards.py vit_sp     # ViT-B/16 at tp=2 sp=2
    python3 tools/parallel_cards.py dryrun vit_sp   # both, one build

Builds the kernels, then trains the `train` phase's GPT-2 125M (same seed,
weights and batch; with `llama`, the `train_llama` phase's Llama-125M)
through the sharded step in a `TorchTrainer` gang of one NCCL GPU worker
per visible card (`chip_smoke.parallel_gang`: four cards give
`_pick_strategy(4)`, fsdp=2 tp=2), and holds its losses to the one-rank
phase's losses on the same weights and batch (`REFS`, each from a whole
smoke on NVIDIA H100 80GB HBM3, 700 W). Beside them, that run's `train`
(`train_llama`) K=1 / K=4 step ms, printed beside the gang's. Prints the
phase's line and its row as JSON.

`dryrun` runs `ray_tpu_torch.dryrun`: `entry()` on card 0, then
`dryrun_multichip(4)`, one NCCL rank a card (fsdp=2 tp=2; ep=4; a
4-stage pipeline; dcn=2 x fsdp=2 on a hybrid mesh), each step held to
one rank's value. `vit_sp` runs `chip_smoke.vit_sp_cards`: ViT-B/16 at
B=64 on a tp=2 sp=2 mesh over NCCL, graphed at K=1, against the one-card
unsharded graphed run of the same weights and batch in the same call.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

ONE_RANK_LOSSES = [
    10.973572731018066, 10.672130584716797, 10.357168197631836,
    10.170507431030273, 9.928362846374512, 9.794107437133789,
    9.657626152038574, 9.454497337341309, 9.204626083374023,
    9.000784873962402, 8.797502517700195, 8.58687973022461,
    8.500062942504883, 8.330854415893555]
REF_MS = (86.20863350000008, 83.90389149999915)
LLAMA_ONE_RANK_LOSSES = [
    10.528428077697754, 10.244949340820312, 9.956871032714844,
    9.722111701965332, 9.494029998779297, 9.289459228515625,
    9.083341598510742, 8.873579025268555, 8.657715797424316,
    8.42133903503418, 8.1685791015625, 7.942204475402832, 7.72705078125,
    7.4531378746032715]
LLAMA_REF_MS = (75.09791330000013, 74.20928983333279)
# family: (the one-rank losses, the reference step ms, the config)
REFS = {"gpt": (ONE_RANK_LOSSES, REF_MS, "gpt2_125m"),
        "llama": (LLAMA_ONE_RANK_LOSSES, LLAMA_REF_MS, "llama_125m")}


def dryrun():
    from ray_tpu_torch import dryrun as dry

    fn, args = dry.entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype, flush=True)
    t0 = time.time()
    row = dry.dryrun_multichip(4)
    row["wall_s"] = time.time() - t0
    return row


def main(argv) -> int:
    import torch

    t0 = time.time()
    print("card", chip_smoke.card_line(), torch.cuda.device_count(),
          flush=True)
    chip_smoke.phase_build()
    for mode in argv or ["gpt"]:  # several modes share one build
        if mode == "dryrun":
            row = dryrun()
        elif mode == "vit_sp":
            row = chip_smoke.vit_sp_cards()
        else:
            losses, ref_ms, model = REFS[mode]
            row = chip_smoke.parallel_gang(losses, ref_ms, model=model,
                                           family=mode)
        print("ROW", mode, json.dumps(row, default=lambda a: getattr(
            a, "tolist", lambda: str(a))()), flush=True)
    print("total", time.time() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
