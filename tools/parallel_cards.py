#!/usr/bin/env python3
"""`chip_smoke.py` phase 16 (a) alone, on every visible card.

    python3 tools/parallel_cards.py            # on a host with four cards

Builds the kernels, then trains the `train` phase's GPT-2 125M (same seed,
weights and batch) through the sharded step in a `TorchTrainer` gang of
one NCCL GPU worker per visible card (`chip_smoke.parallel_gang`: four
cards give `_pick_strategy(4)`, fsdp=2 tp=2), and holds its losses to
`ONE_RANK_LOSSES`: the one-rank phase's losses on the same weights and
batch, from a whole smoke on NVIDIA H100 80GB HBM3, 700 W (those were
within 9.83e-5 of the `train` phase's). `REF_MS` is that run's `train`
K=1 / K=4 step ms, printed beside the gang's. Prints the phase's line and
its row as JSON.
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


def main() -> int:
    import torch

    t0 = time.time()
    print("card", chip_smoke.card_line(), torch.cuda.device_count(),
          flush=True)
    chip_smoke.phase_build()
    row = chip_smoke.parallel_gang(ONE_RANK_LOSSES, REF_MS)
    print("GANG", json.dumps(row, default=str), flush=True)
    print("total", time.time() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
